"""Seed-parallel training: S independent learner fits stacked into one
(counterpart of meta_learning_pacoh_tpu/parallel/seed_parallel.py).

The reference scales experiment sweeps by launching one process per
(config, seed) (reference: experiments/baselines/baseline_comparison.py:65-123,
experiments/util.py:160-185). Here, as in the JAX package, the seed axis
becomes a tensor axis: the S learners' state is stacked on a leading axis
(``SeedStack``) and each learner class's ``_stacked_step`` advances all S
fits at once. A step then costs the host about what one fit's step costs,
while every product, MLL system and Stein transport of the step gains the
axis S: the MLL kernels K2/K3 or B4 see S K T systems in one launch, and
the Stein kernel K1 one launch of S clusters (``ops/cuda/svgd_kernel.py``).

Each fit keeps its own draws: at global step s, model i's task draws and
noise are exactly those its own ``meta_fit`` would draw there (a generator
seeded with (model i's train seed, s)), so the stacked fit equals S
sequential general-step fits up to float reassociation. The learners share
one static configuration (checked); their meta-train data may differ, as
long as the padded shapes match (the meta-overfitting sweep's per-seed
draws).

Usage:
    models = [GPRegressionMetaLearned(data, random_seed=s) for s in seeds]
    fit_models_parallel(models, n_iter=10000)   # all S fitted in place

With ``mesh=`` (``make_seed_mesh``) the seed axis is split over the ranks
of the mesh: each rank stacks its contiguous share of the fits (a count
that does not divide the mesh is padded with the last model, whose extra
fits are discarded), no rank talks to another while they train, and an
all_gather at the end hands every rank every model's state.
"""

import time

import torch

from meta_learning_pacoh_torch.ops import launch_sched
from meta_learning_pacoh_torch.parallel import mesh as mesh_ops
# the JAX module's public name, re-exported
from meta_learning_pacoh_torch.parallel.mesh import make_seed_mesh  # noqa: F401

_GP_DATA = ("X", "Y", "mask")
_GP_PRIOR = ("cfg", "_weight_prior_std", "_bias_prior_std")
_TASKS = ("task_batch_size", "n_tasks", "_optimizer_name", "_lr_decay", "device")
# per class: (the attributes of the trained state, stacked; the meta-train
# data, stacked; the static configuration, equal across the models)
_SPECS = {
    "GPRegressionMetaLearned": (
        ("params", "_mu", "_nu"), _GP_DATA,
        ("cfg", "learning_mode", "lr_params", "weight_decay") + _TASKS),
    "GPRegressionMetaLearnedSVGD": (
        ("particles", "_mu", "_nu"), _GP_DATA,
        _GP_PRIOR + ("num_particles", "svgd_kernel", "bandwidth", "prior_factor", "_lr")
        + _TASKS),
    "GPRegressionMetaLearnedVI": (
        ("posterior", "_mu", "_nu"), _GP_DATA,
        _GP_PRIOR + ("svi_batch_size", "_cov_type", "prior_factor", "_lr") + _TASKS),
    "GPRegressionMetaLearnedPAC": (
        ("params", "_mu", "_nu"), _GP_DATA,
        _GP_PRIOR + ("svi_batch_size", "_cov_type", "lr", "_posterior_lr_multiplier", "delta",
                     "task_kl_weight", "meta_kl_weight") + _TASKS),
    "MAMLRegression": (
        ("params", "_mu", "_nu"), ("X", "Y", "_w_inner", "_w_outer"),
        ("layout", "lr_inner", "num_inner_steps", "_lr", "weight_decay") + _TASKS),
    "NPRegressionMetaLearned": (
        ("params", "_mu", "_nu"), ("X", "Y", "mask", "_num_context"),
        ("layout", "z_dim", "_lr", "weight_decay") + _TASKS),
}


def _stack(values):
    if isinstance(values[0], dict):
        return {k: torch.stack([v[k] for v in values]) for k in values[0]}
    return torch.stack(values)


def _take(stacked, i):
    if isinstance(stacked, dict):
        return {k: v[i].clone() for k, v in stacked.items()}
    return stacked[i].clone()


class SeedStack:
    """S learners of one class and configuration at one step, their state
    stacked on a leading axis S on their device.

    ``state`` maps each state attribute of the class (a tensor or a dict of
    tensors) to its stack, updated in place by the class's
    ``_stacked_step``; ``data`` holds the meta-train tensors [S, T, ...];
    ``step`` and ``adam_count`` are the fits' common counts. A learner's
    ``_stacked_step`` reads each fit's hyperparameters through ``per_seed``
    and ``staircase``, its sampled task batches through ``gather``, and
    its draws from the models themselves.
    """

    def __init__(self, models):
        m0 = models[0]
        state_attrs, data_attrs, _ = _SPECS[type(m0).__name__]
        self.models = list(models)
        self.device = m0.device
        self.state = {a: _stack([getattr(m, a) for m in models]) for a in state_attrs}
        self.data = tuple(torch.stack([getattr(m, a) for m in models]) for a in data_attrs)
        self.step = m0._step_count
        self.adam_count = m0._adam_count
        self._seed_rows = torch.arange(len(models), device=self.device)[:, None]
        self._values = {}

    def per_seed(self, key, value_of=None):
        """[S] float32 on the device: each model's attribute ``key``, or
        ``value_of(model)`` (kept under ``key``: computed once)."""
        if key not in self._values:
            value_of = value_of or (lambda m: getattr(m, key))
            self._values[key] = torch.tensor([float(value_of(m)) for m in self.models],
                                             dtype=torch.float32, device=self.device)
        return self._values[key]

    def staircase(self, lr0):
        """[S]: each model's lr at the stack's step under its staircase
        schedule, from its initial lr ``lr0`` (an attribute's name or a
        function of the model). Each value is the float32 of the number the
        sequential step computes, so every fit takes its own step's lr."""
        m0 = self.models[0]
        stair = (self.step // launch_sched.LR_TRANSITION_STEPS if m0._lr_decay < 1.0 else 0)
        of = lr0 if callable(lr0) else (lambda m: getattr(m, lr0))
        step = self.step
        return self.per_seed((lr0, stair), lambda m: launch_sched.staircase_lr(
            of(m), m._lr_decay, step))

    def gather(self, data, draws):
        """Each fit's sampled task batch: rows ``draws[i]`` (CPU index
        tensors [B]) of every tensor [S, T, ...] of ``data`` -> [S, B, ...]."""
        idx = torch.stack(list(draws)).to(self.device)
        return tuple(d[self._seed_rows, idx] for d in data)

    def unstack(self):
        """Write each fit's state and counts back to its model."""
        for i, m in enumerate(self.models):
            for attr, stacked in self.state.items():
                setattr(m, attr, _take(stacked, i))
            m._step_count = self.step
            m._adam_count = self.adam_count
            m.fitted = True
            if hasattr(m, "_fused"):
                m._fused = None  # a fused trainer is rebuilt at the next fused fit


def check_group(models, free=()):
    """Raise unless ``models`` are learners of one supported class at one
    step whose static configuration, all but the attributes ``free``, and
    data shapes agree."""
    if not models:
        raise ValueError("no models")
    m0 = models[0]
    cls = type(m0).__name__
    if cls not in _SPECS:
        raise NotImplementedError(f"seed-parallel fit not supported for {cls}")
    if not all(type(m) is type(m0) for m in models):
        raise ValueError("all models must be of one class")
    for attr in _SPECS[cls][2]:
        if attr not in free and not all(getattr(m, attr) == getattr(m0, attr) for m in models):
            raise ValueError(f"all models must share one static configuration: {attr} differs")
    for attr in _SPECS[cls][1]:
        if not all(getattr(m, attr).shape == getattr(m0, attr).shape for m in models):
            raise ValueError(f"all models' {attr} must have one shape")
    if not all(m._step_count == m0._step_count and m._adam_count == m0._adam_count
               for m in models):
        raise ValueError("all models must be at the same training step")


def fit_stacked(models, n_iter, log_period=5000, verbose=False, mesh=None, axis=None):
    """``n_iter`` general steps of the checked group ``models``, stacked;
    each model's state, counts and ``fitted`` written back at the end.
    With a mesh, each rank stacks its contiguous share of ``models`` on the
    mesh axis ``axis`` (a count that does not divide the axis is padded with
    the last model, whose extra fits are discarded), and the stacked states
    are gathered over the axis into every model, on every rank."""
    local = list(models)
    if mesh is not None:
        for m in models:
            mesh_ops.check_mesh_device(mesh, m.device)
        d = mesh_ops.axis_size(mesh, axis)
        padded = local + [local[-1]] * ((-len(local)) % d)
        local = padded[mesh_ops.shard_rows(mesh, len(padded), axis)]
    m0 = local[0]
    stack = SeedStack(local)
    t, done = time.time(), 0
    while done < n_iter:
        chunk = int(min(log_period, n_iter - done))
        for _ in range(chunk):
            m0._stacked_step(stack)
        done += chunk
        if verbose:
            if stack.device.type == "cuda":
                torch.cuda.synchronize(stack.device)
            m0.logger.info("seed-parallel (%d models): iter %d/%d - %.2f sec"
                           % (len(local), done, n_iter, time.time() - t))
            t = time.time()
    if mesh is not None:
        group = mesh_ops.axis_group(mesh, axis)

        def gather(stacked):
            if isinstance(stacked, dict):
                return {k: gather(v) for k, v in stacked.items()}
            return mesh_ops.all_gather(stacked, group).reshape(-1, *stacked.shape[1:])

        stack.state = {attr: gather(stacked) for attr, stacked in stack.state.items()}
        stack.models = list(models)
    stack.unstack()
    return models


def _all_fused(models):
    return all(getattr(m, "_fused_path_ok", lambda: False)() for m in models)


def fit_models_parallel(models, n_iter=None, log_period=5000, mesh=None, verbose=False,
                        prefer="auto"):
    """Meta-fit S same-config learners at once.

    models:     learners of one class in ``_SPECS`` and one static
                configuration (checked), all at the same step; their data
                shapes must match, the data may differ.
    n_iter:     steps for every model (default: models[0].num_iter_fit).
    log_period: steps between log lines with ``verbose`` (the stacked fit
                is one step a loop iteration: chunking never changes
                results).
    mesh:       optional mesh with a 'seed' axis (``make_seed_mesh``): the
                stacked seed axis is split over its ranks, any S on any
                mesh (see the module's docstring); every rank builds the
                same models and calls this. The learners themselves carry
                no mesh.
    prefer:     'vmap' | 'sequential_fused' | 'auto'.
                'vmap' stacks the S fits into one general step a step (the
                name of the JAX package's vmapped route). 'sequential_fused'
                runs each model's own ``meta_fit``, so a configuration in a
                fused window rides its single-launch training kernel (B2,
                B6, B7, B8, B9, B10, B11), exactly as per-model fits.
                'auto' takes 'sequential_fused' where every model is in a
                fused window and no mesh is given, and 'vmap' elsewhere;
                'sequential_fused' with a mesh raises. MEASURED on one NVIDIA
                H100 80GB HBM3 at a 700 W power limit (chip_smoke.py phase
                12b, two calls: the meta-overfitting sweep's PACOH-MAP cell
                on sin_32, seeds 22-26, sampled task batches of 5): 'vmap'
                2.229 and 2.722 ms a fit-step (1,000 stacked steps of the 5
                fits in 11.144 and 13.611 s: the general step at N=5 is
                host-bound), 'sequential_fused' 0.034 and 0.026 ms (5 x
                10,000 B6 steps in 1.700 and 1.309 s, trainer builds
                included): the fused fits 65.5x and 103.9x faster.
                Stacking pays where no fused kernel fits: on cauchy_20's
                general step (phase 12a, three calls) five stacked SVGD fits
                step at 0.93-1.03 times the rate of one (181.7-241.0
                against 195.1-233.1 steps/s).

    Mutates each model in place as ``model.meta_fit(n_iter=n_iter)`` would
    (state, optimizer state, step counts, ``fitted``), up to float
    reassociation in the stacked products ('sequential_fused' is exactly
    per-model ``meta_fit``). A kernel error raises; it is never rerouted.
    """
    if prefer not in ("auto", "vmap", "sequential_fused"):
        raise ValueError(f"prefer must be 'auto', 'vmap' or 'sequential_fused', got {prefer!r}")
    if n_iter is None:
        n_iter = models[0].num_iter_fit
    if prefer == "auto":
        prefer = "vmap" if mesh is not None or not _all_fused(models) else "sequential_fused"
    if prefer == "sequential_fused":
        if mesh is not None:
            raise ValueError("sequential_fused runs every fit on every rank; with a mesh "
                             "use prefer='vmap' (or 'auto'), which splits the seed axis")
        if not _all_fused(models):
            raise ValueError("sequential_fused requires every model in a fused window")
        for m in models:
            m.meta_fit(verbose=verbose, log_period=log_period, n_iter=n_iter)
        return models
    check_group(models)
    if not all(getattr(m, "_mesh", None) is None for m in models):
        raise ValueError("seed-parallel fit shards the seed axis itself; construct the "
                         "learners with mesh=None")
    if mesh is not None and "seed" not in mesh.mesh_dim_names:
        raise ValueError("the mesh needs a 'seed' axis")
    return fit_stacked(models, n_iter, log_period=log_period, verbose=verbose, mesh=mesh,
                       axis="seed")
