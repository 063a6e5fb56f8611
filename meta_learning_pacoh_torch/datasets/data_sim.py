"""Meta-learning task environments (a numpy copy of meta_learning_pacoh_tpu/datasets/data_sim.py).

The port carries its own copy because importing the JAX package's module
imports jax. The random draws are made in the same order, so a seed gives
byte-equal arrays in both packages.

Behavioral parity with the reference's data layer (reference:
experiments/data_sim.py): the same seven task distributions with the same
parameterizations, the `generate_meta_train_data(n_tasks, n_samples)` /
`generate_meta_test_data(n_tasks, n_samples_context, n_samples_test)`
contract, and the `provide_data(dataset, seed)` string registry with the
same defaults (sin_*, sin-nonstat*, gp_funcs, cauchy_*, mnist, physionet_*,
swissfel; N_VALID = N_TEST = 200 tasks, 200 test samples).

Task *generation* is plain numpy on the host — it's one-time setup, not the
training hot path; the framework consumes the tuples as padded [T, N, D]
device tensors.
"""

import copy
import os

import numpy as np

X_LOW, X_HIGH = -5, 5

DATA_DIR = os.environ.get(
    "PACOH_DATA_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "data"),
)
MNIST_DIR = os.path.join(DATA_DIR, "mnist")
PHYSIONET_DIR = os.path.join(DATA_DIR, "physionet2012")
SWISSFEL_DIR = os.path.join(DATA_DIR, "swissfel")


class MetaDataset:
    """Base task environment (reference: data_sim.py:20-34)."""

    def __init__(self, random_state=None):
        self.random_state = random_state if random_state is not None else np.random

    def generate_meta_train_data(self, n_tasks: int, n_samples: int) -> list:
        raise NotImplementedError

    def generate_meta_test_data(self, n_tasks: int, n_samples_context: int,
                                n_samples_test: int) -> list:
        raise NotImplementedError


class SinusoidDataset(MetaDataset):
    """Random sinusoids + linear trend (reference: data_sim.py:203-248).

    f(x) = slope * x + amp * sin(period * (x - x_shift)) + y_shift,
    amp ~ U(0.7, 1.3), slope ~ N(0.5, 0.2), x_shift ~ N(0, 0.1),
    y_shift ~ N(5, 0.1), period = 1.5, observation noise N(0, 0.1^2).
    """

    def __init__(self, amp_low=0.7, amp_high=1.3, period_low=1.5, period_high=1.5,
                 x_shift_mean=0.0, x_shift_std=0.1, y_shift_mean=5.0, y_shift_std=0.1,
                 slope_mean=0.5, slope_std=0.2, noise_std=0.1, x_low=-5, x_high=5,
                 random_state=None):
        super().__init__(random_state)
        assert y_shift_std >= 0 and noise_std >= 0
        self.amp_low, self.amp_high = amp_low, amp_high
        self.period_low, self.period_high = period_low, period_high
        self.x_shift_mean, self.x_shift_std = x_shift_mean, x_shift_std
        self.y_shift_mean, self.y_shift_std = y_shift_mean, y_shift_std
        self.slope_mean, self.slope_std = slope_mean, slope_std
        self.noise_std = noise_std
        self.x_low, self.x_high = x_low, x_high

    def _sample_fn(self):
        rs = self.random_state
        amp = rs.uniform(self.amp_low, self.amp_high)
        x_shift = rs.normal(self.x_shift_mean, self.x_shift_std)
        y_shift = rs.normal(self.y_shift_mean, self.y_shift_std)
        slope = rs.normal(self.slope_mean, self.slope_std)
        period = rs.uniform(self.period_low, self.period_high)
        return lambda x: slope * x + amp * np.sin(period * (x - x_shift)) + y_shift

    def _sample_task(self, n):
        f = self._sample_fn()
        x = self.random_state.uniform(self.x_low, self.x_high, size=(n, 1))
        y = f(x) + self.noise_std * self.random_state.normal(size=(n, 1))
        return x, y

    def generate_meta_train_data(self, n_tasks, n_samples):
        return [self._sample_task(n_samples) for _ in range(n_tasks)]

    def generate_meta_test_data(self, n_tasks, n_samples_context, n_samples_test):
        assert n_samples_test > 0
        out = []
        for _ in range(n_tasks):
            x, y = self._sample_task(n_samples_context + n_samples_test)
            out.append((x[:n_samples_context], y[:n_samples_context],
                        x[n_samples_context:], y[n_samples_context:]))
        return out


class SinusoidNonstationaryDataset(MetaDataset):
    """Nonstationary sinusoids (reference: data_sim.py:251-284):
    f(x) = intersect + slope*x + sin((1+|x|) x) + noise,
    intersect ~ N(-2, 0.2), slope ~ N(1, 0.3)."""

    def __init__(self, noise_std=0.0, x_low=-5, x_high=5, random_state=None):
        super().__init__(random_state)
        self.noise_std = noise_std
        self.x_low, self.x_high = x_low, x_high

    def _sample_fn(self):
        rs = self.random_state
        intersect = rs.normal(-2.0, 0.2)
        slope = rs.normal(1.0, 0.3)

        def f(x):
            noise = rs.normal(0.0, self.noise_std, size=x.shape) if self.noise_std > 0 \
                else np.zeros_like(x)
            return intersect + slope * x + np.sin((1 + np.abs(x)) * x) + noise

        return f

    def _sample_task(self, n):
        f = self._sample_fn()
        x = self.random_state.uniform(self.x_low, self.x_high, size=(n, 1))
        return x, f(x)

    def generate_meta_train_data(self, n_tasks, n_samples):
        return [self._sample_task(n_samples) for _ in range(n_tasks)]

    def generate_meta_test_data(self, n_tasks, n_samples_context, n_samples_test):
        assert n_samples_test > 0
        out = []
        for _ in range(n_tasks):
            x, y = self._sample_task(n_samples_context + n_samples_test)
            out.append((x[:n_samples_context], y[:n_samples_context],
                        x[n_samples_context:], y[n_samples_context:]))
        return out


def _se_gram(a, b, lengthscale):
    """exp(-0.5 * ||a-b||^2 / lengthscale) (reference kernel, data_sim.py:318-320)."""
    sq = np.sum(a**2, 1)[:, None] + np.sum(b**2, 1)[None, :] - 2 * a @ b.T
    return np.exp(-0.5 * sq / lengthscale)


class GPFunctionsDataset(MetaDataset):
    """Functions drawn from an SE-kernel GP prior (reference: data_sim.py:287-326)."""

    def __init__(self, noise_std=0.1, lengthscale=1.0, mean=0.0, x_low=-5, x_high=5,
                 random_state=None):
        super().__init__(random_state)
        self.noise_std, self.lengthscale, self.mean = noise_std, lengthscale, mean
        self.x_low, self.x_high = x_low, x_high

    def _gp_draw(self, x):
        n = x.shape[0]
        K = _se_gram(x, x, self.lengthscale)
        L = np.linalg.cholesky(K + 1e-8 * np.eye(n))
        f = self.mean + L @ self.random_state.normal(size=(n, 1))
        return f + self.random_state.normal(scale=self.noise_std, size=f.shape)

    def _sample_task(self, n):
        x = self.random_state.uniform(self.x_low, self.x_high, size=(n, 1))
        return x, self._gp_draw(x)

    def generate_meta_train_data(self, n_tasks, n_samples):
        return [self._sample_task(n_samples) for _ in range(n_tasks)]

    def generate_meta_test_data(self, n_tasks, n_samples_context, n_samples_test):
        assert n_samples_test > 0
        out = []
        for _ in range(n_tasks):
            x, y = self._sample_task(n_samples_context + n_samples_test)
            out.append((x[:n_samples_context], y[:n_samples_context],
                        x[n_samples_context:], y[n_samples_context:]))
        return out


class CauchyDataset(MetaDataset):
    """Two-bump Cauchy mean + SE-GP residual, truncated-normal inputs
    (reference: data_sim.py:329-375)."""

    def __init__(self, noise_std=0.05, ndim_x=2, random_state=None):
        super().__init__(random_state)
        self.noise_std = noise_std
        self.ndim_x = ndim_x

    def _mean(self, x):
        loc1 = -1.0 * np.ones(x.shape[-1])
        loc2 = 2.0 * np.ones(x.shape[-1])
        c1 = 1.0 / (np.pi * (1 + np.linalg.norm(x - loc1, axis=-1) ** 2))
        c2 = 1.0 / (np.pi * (1 + np.linalg.norm(x - loc2, axis=-1) ** 2))
        return 6 * c1 + 3 * c2 + 1

    def _sample_x(self, n):
        from scipy.stats import truncnorm

        return truncnorm.rvs(-3, 2, loc=0, scale=2.5, size=(n, self.ndim_x),
                             random_state=self.random_state)

    def _sample_task(self, n):
        x = self._sample_x(n)
        K = _se_gram(x, x, 0.5)
        L = np.linalg.cholesky(K + 1e-8 * np.eye(n))
        f = self._mean(x) + (L @ self.random_state.normal(scale=0.2, size=(n, 1))).flatten()
        y = f + self.random_state.normal(scale=self.noise_std, size=f.shape)
        return x, y.reshape(-1, 1)

    def generate_meta_train_data(self, n_tasks, n_samples):
        return [self._sample_task(n_samples) for _ in range(n_tasks)]

    def generate_meta_test_data(self, n_tasks, n_samples_context, n_samples_test):
        assert n_samples_test > 0
        out = []
        for _ in range(n_tasks):
            x, y = self._sample_task(n_samples_context + n_samples_test)
            out.append((x[:n_samples_context], y[:n_samples_context],
                        x[n_samples_context:], y[n_samples_context:]))
        return out


def _parse_idx_images(path):
    """Minimal IDX3 image parser (plain or .gz) — replaces the `mnist`
    package dependency when the raw files are available locally."""
    import gzip
    import struct

    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, num, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"not an IDX3 image file: {path}"
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(num, rows, cols)


class MNISTRegressionDataset(MetaDataset):
    """Pixel regression: (row, col) -> intensity per image
    (reference: data_sim.py:134-200). Uses the `mnist` package if installed,
    else parses local idx files under data/mnist (zero-egress fallback)."""

    def __init__(self, random_state=None, dtype=np.float32):
        super().__init__(random_state)
        self.dtype = dtype

        try:
            import mnist

            mnist_dir = MNIST_DIR if os.path.isdir(MNIST_DIR) else None
            self.train_images = mnist.download_and_parse_mnist_file(
                "train-images-idx3-ubyte.gz", target_dir=mnist_dir) / 255.0
            self.test_images = mnist.download_and_parse_mnist_file(
                "t10k-images-idx3-ubyte.gz", target_dir=mnist_dir) / 255.0
            return
        except ImportError:
            pass

        def find(*names):
            for name in names:
                p = os.path.join(MNIST_DIR, name)
                if os.path.exists(p):
                    return p
            raise FileNotFoundError(
                f"MNIST idx files not found in {MNIST_DIR} "
                f"(looked for {names}) and the `mnist` package is unavailable"
            )

        self.train_images = _parse_idx_images(
            find("train-images-idx3-ubyte.gz", "train-images-idx3-ubyte")
        ) / 255.0
        self.test_images = _parse_idx_images(
            find("t10k-images-idx3-ubyte.gz", "t10k-images-idx3-ubyte")
        ) / 255.0

    def _image_to_task(self, image, n_context):
        size = image.shape[0]
        assert image.ndim == 2 and image.shape[0] == image.shape[1]
        assert n_context <= size**2
        coords = np.stack(np.meshgrid(np.arange(size), np.arange(size)), -1).reshape(-1, 2)
        perm = self.random_state.permutation(size**2)
        ctx_idx, test_idx = perm[:n_context], perm[n_context:]
        vals = image[coords[:, 1], coords[:, 0]]
        to = lambda a: np.asarray(a, dtype=self.dtype)
        return (to(coords[ctx_idx]), to(vals[ctx_idx]),
                to(coords[test_idx]), to(vals[test_idx]))

    def generate_meta_train_data(self, n_tasks, n_samples):
        idxs = self.random_state.choice(self.train_images.shape[0], size=n_tasks, replace=False)
        return [self._image_to_task(self.train_images[i], n_samples)[:2] for i in idxs]

    def generate_meta_test_data(self, n_tasks, n_samples_context, n_samples_test=-1):
        idxs = self.random_state.choice(self.test_images.shape[0], size=n_tasks, replace=False)
        out = []
        for i in idxs:
            xc, yc, xt, yt = self._image_to_task(self.test_images[i], n_samples_context)
            if 0 < n_samples_test < xt.shape[0]:
                sel = self.random_state.choice(xt.shape[0], size=n_samples_test, replace=False)
                xt, yt = xt[sel], yt[sel]
            out.append((xc, yc, xt, yt))
        return out


class PhysionetDataset(MetaDataset):
    """ICU time series from the Physionet-2012 HDF5 dump (reference:
    data_sim.py:37-131). Tasks are ragged — the framework pads + masks them."""

    VARIABLES = ["GCS", "Urine", "HCT", "BUN", "Creatinine", "DiasABP"]

    def __init__(self, random_state=None, variable_id=0, dtype=np.float32,
                 physionet_dir=None):
        super().__init__(random_state)
        self.dtype = dtype
        self.data_dir = physionet_dir or PHYSIONET_DIR
        assert variable_id < len(self.VARIABLES), "Unknown variable ID"
        self.variable = self.VARIABLES[variable_id]
        self.data_path = os.path.join(self.data_dir, "set_a_merged.h5")
        # The reference ships set_a_merged.h5 in pandas/PyTables format
        # (reference data_sim.py:59-90). PyTables is not always available
        # (it is absent from the TPU container), so a plain h5py layout is
        # also accepted: one group per patient holding a 'times' dataset and
        # one dataset per variable name. Detection is CONTENT-based (pandas
        # stores tag their groups with a 'pandas_type' attr), not
        # import-based — a plain-h5py file must read correctly even on
        # machines where PyTables happens to be installed.
        self._use_pandas = self._detect_pandas_layout()
        if self._use_pandas:
            import pandas as pd

            with pd.HDFStore(self.data_path, mode="r") as hdf:
                self.keys = list(hdf.keys())
        else:
            import h5py

            with h5py.File(self.data_path, "r") as hdf:
                self.keys = sorted("/" + k for k in hdf.keys())

    def _detect_pandas_layout(self):
        try:
            import h5py
        except ImportError:
            return True  # no h5py: only the pandas/PyTables reader can try
        with h5py.File(self.data_path, "r") as hdf:
            for k in hdf.keys():
                return "pandas_type" in hdf[k].attrs
        return True  # empty file: let pandas report the error

    def _patient_series(self, patient):
        if self._use_pandas:
            import pandas as pd

            df = pd.read_hdf(self.data_path, patient, mode="r")[self.variable].dropna()
            return (df.index.values.astype(self.dtype), df.values.astype(self.dtype))
        import h5py

        with h5py.File(self.data_path, "r") as hdf:
            grp = hdf[patient.lstrip("/")]
            times = grp["times"][()].astype(self.dtype)
            values = grp[self.variable][()].astype(self.dtype)
        keep = ~np.isnan(values)
        return times[keep], values[keep]

    def generate_meta_train_data(self, n_tasks, n_samples=47):
        assert n_tasks <= 500 and n_samples < 48
        out = []
        for patient in self.keys:
            times, values = self._patient_series(patient)
            keep = times <= n_samples
            if keep.sum() >= 4:
                out.append((times[keep], values[: int(keep.sum())]))
            if len(out) >= n_tasks:
                break
        return out

    def generate_meta_test_data(self, n_tasks, n_samples_context=24, n_samples_test=-1):
        assert n_tasks <= 1000 and n_samples_context < 48
        out = []
        for patient in reversed(self.keys):
            times, values = self._patient_series(patient)
            n_ctx = int((times <= n_samples_context).sum())
            if n_ctx >= 4 and n_ctx < len(times):
                out.append((times[:n_ctx], values[:n_ctx], times[n_ctx:], values[n_ctx:]))
            if len(out) >= n_tasks:
                break
        return out


class SwissfelDataset(MetaDataset):
    """SwissFEL accelerator-tuning runs (reference: data_sim.py:380-497)."""

    RUNS_12DIM = [
        {"experiment": "2018_10_31/line_ucb_ascent", "run": 0},
        {"experiment": "2018_10_31/line_ucb_ascent", "run": 1},
        {"experiment": "2018_10_31/line_ucb_ascent", "run": 2},
        {"experiment": "2018_10_31/line_ucb", "run": 0},
        {"experiment": "2018_10_31/line_ucb", "run": 1},
        {"experiment": "2018_10_31/line_ucb", "run": 2},
        {"experiment": "2018_10_31/neldermead", "run": 0},
        {"experiment": "2018_10_31/neldermead", "run": 1},
        {"experiment": "2018_10_31/neldermead", "run": 2},
    ]
    RUNS_24DIM = [
        {"experiment": "2018_11_01/line_ucb_ascent_bpm_24", "run": 0},
        {"experiment": "2018_11_01/line_ucb_ascent_bpm_24", "run": 1},
        {"experiment": "2018_11_01/line_ucb_ascent_bpm_24", "run": 3},
        {"experiment": "2018_11_01/line_ucb_ascent_bpm_24_small", "run": 0},
        {"experiment": "2018_11_01/lipschitz_line_ucb_bpm_24", "run": 0},
        {"experiment": "2018_11_01/neldermead_bpm_24", "run": 0},
        {"experiment": "2018_11_01/neldermead_bpm_24", "run": 1},
        {"experiment": "2018_11_01/parameter_scan_bpm_24", "run": 0},
    ]

    def __init__(self, random_state=None, param_space_id=0, swissfel_dir=None):
        super().__init__(random_state)
        self.swissfel_dir = swissfel_dir or SWISSFEL_DIR
        runs = copy.deepcopy(self.RUNS_12DIM if param_space_id == 0 else self.RUNS_24DIM)
        self.random_state.shuffle(runs)
        self.run_specs_train = runs[:5]
        self.run_specs_test = runs[5:]

    def _load_run(self, experiment, run=0):
        import h5py

        path = os.path.join(self.swissfel_dir, experiment)
        with h5py.File(os.path.join(path, "data/evaluations.hdf5"), "r") as dset:
            data = dset["1"][str(run)][()]
        return data

    def _load_meta(self, train=True):
        specs = self.run_specs_train if train else self.run_specs_test
        tuples = [(d["x"], d["y"]) for d in (self._load_run(**s) for s in specs)]
        assert len({x.shape[-1] for x, _ in tuples}) == 1
        return tuples

    def generate_meta_train_data(self, n_tasks=5, n_samples=200):
        assert n_tasks == len(self.run_specs_train)
        tuples = self._load_meta(train=True)
        assert n_samples <= max(x.shape[0] for x, _ in tuples)
        return [(x[:n_samples], y[:n_samples]) for x, y in tuples]

    def generate_meta_test_data(self, n_tasks=None, n_samples_context=200,
                                n_samples_test=400):
        if n_tasks is None:
            n_tasks = len(self.run_specs_test)
        assert n_tasks == len(self.run_specs_test)
        tuples = self._load_meta(train=False)
        total = n_samples_context + n_samples_test
        assert total <= min(x.shape[0] for x, _ in tuples)
        idx = np.arange(total)
        self.random_state.shuffle(idx)
        ic, it = idx[:n_samples_context], idx[n_samples_context:]
        return [(x[ic], y[ic], x[it], y[it]) for x, y in tuples]


def provide_data(dataset, seed=28, n_train_tasks=None, n_samples=None):
    """String registry -> (train, valid, test) task-tuple lists
    (reference: data_sim.py:501-617, same defaults)."""
    n_test_tasks = 200
    n_valid_tasks = 200
    n_test_samples = 200

    if "sin-nonstat" in dataset:
        if len(dataset.split("_")) == 2:
            n_train_tasks = int(dataset.split("_")[-1])
        env = SinusoidNonstationaryDataset(random_state=np.random.RandomState(seed + 1))
        n_train = n_ctx = 20 if n_samples is None else n_samples
        n_train_tasks = n_train_tasks or 20
    elif "sin" in dataset:
        if len(dataset.split("_")) == 2:
            n_train_tasks = int(dataset.split("_")[-1])
        env = SinusoidDataset(random_state=np.random.RandomState(seed + 1))
        n_train = n_ctx = 5 if n_samples is None else n_samples
        n_train_tasks = n_train_tasks or 20
    elif "gp_funcs" in dataset:
        env = GPFunctionsDataset(random_state=np.random.RandomState(seed + 1))
        n_train = n_ctx = 5 if n_samples is None else n_samples
        n_train_tasks = n_train_tasks or 20
    elif "cauchy" in dataset:
        if len(dataset.split("_")) == 2:
            n_train_tasks = int(dataset.split("_")[-1])
        env = CauchyDataset(random_state=np.random.RandomState(seed + 1))
        n_train = n_ctx = 20 if n_samples is None else n_samples
        n_train_tasks = n_train_tasks or 20
    elif dataset == "mnist":
        env = MNISTRegressionDataset(random_state=np.random.RandomState(seed + 1))
        n_test_samples = -1
        n_valid_tasks = n_test_tasks = 1000
        n_ctx = 200
        n_train = 28 * 28
        n_train_tasks = n_train_tasks or 1000
    elif "physionet" in dataset:
        variable_id = int(dataset[-1])
        assert 0 <= variable_id <= 5
        env = PhysionetDataset(random_state=np.random.RandomState(seed + 1),
                               variable_id=variable_id)
        n_ctx = 24
        n_train = 47
        n_train_tasks = 100
        n_valid_tasks = n_test_tasks = 500
    elif dataset == "swissfel":
        env = SwissfelDataset(random_state=np.random.RandomState(seed + 1))
        n_train_tasks = n_train_tasks or 5
        n_train = n_ctx = 200 if n_samples is None else n_samples
        data_train = env.generate_meta_train_data(n_tasks=n_train_tasks, n_samples=n_train)
        data_tv = env.generate_meta_test_data(n_samples_context=n_ctx, n_samples_test=200)
        # too few swissfel runs for a proper valid/test split (reference :603)
        return data_train, data_tv, data_tv
    else:
        raise NotImplementedError(f"Does not recognize dataset flag {dataset!r}")

    data_train = env.generate_meta_train_data(n_tasks=n_train_tasks, n_samples=n_train)
    data_tv = env.generate_meta_test_data(
        n_tasks=n_test_tasks + n_valid_tasks,
        n_samples_context=n_ctx,
        n_samples_test=n_test_samples,
    )
    data_valid = data_tv[n_valid_tasks:]
    data_test = data_tv[:n_valid_tasks]
    return data_train, data_valid, data_test
