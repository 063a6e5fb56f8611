"""The port's program spans (``utils.profiling.span``) and its ``StepTimer``.

With no profiler recording a span is the one shared no-op, chosen by one
flag read; under a ``torch.profiler`` session the learners and the fused
trainers record their ``pacoh.<layer>.<stage>`` spans, nested as the stages
nest; the spans change no number a fit computes. CPU only: the fused
trainers run their kernels' plain versions here.
"""

import itertools
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meta_learning_pacoh_torch import (
    GPRegressionMetaLearned,
    GPRegressionMetaLearnedPAC,
    GPRegressionMetaLearnedSVGD,
    GPRegressionMetaLearnedVI,
)
from meta_learning_pacoh_torch.datasets import SinusoidDataset
from meta_learning_pacoh_torch.utils import profiling
from meta_learning_pacoh_torch.utils.profiling import (
    LEARNER_EVAL,
    LEARNER_GATE,
    LEARNER_INIT,
    LEARNER_META_FIT,
    LEARNER_META_TEST,
    LEARNER_PREPARE,
    LEARNER_STEP,
    OPS_PREDICTIVE,
    OPS_SCORE,
    OPS_TRANSPORT,
    OPS_UPDATE,
    SPANS,
    StepTimer,
    TRAINER_BUILD,
    TRAINER_LAUNCH,
    TRAINER_PAGES,
)

HIDDEN = (8, 8)
NETS = dict(mean_nn_layers=HIDDEN, kernel_nn_layers=HIDDEN, random_seed=3, device="cpu")
MLAP_KW = dict(covar_module="NN", mean_module="NN", svi_batch_size=2, **NETS)


def _data():
    env = SinusoidDataset(random_state=np.random.RandomState(11))
    train = env.generate_meta_train_data(n_tasks=4, n_samples=5)
    test = env.generate_meta_test_data(n_tasks=3, n_samples_context=5, n_samples_test=10)
    return train, test


TRAIN, TEST = _data()


def recorded(fn):
    """[(name, parent)] of the ``pacoh.*`` spans that ``fn()`` records under a
    CPU profiler, in the order they start; ``parent`` is the innermost
    enclosing ``pacoh.*`` span, or None."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = []
    for ev in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not ev.name.startswith("pacoh."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("pacoh."):
            parent = parent.cpu_parent
        out.append((ev.name, None if parent is None else parent.name))
    return out


def svgd(**kw):
    return GPRegressionMetaLearnedSVGD(TRAIN, num_particles=4, **NETS, **kw)


def test_span_is_the_shared_no_op_while_no_profiler_records(monkeypatch):
    def refuse(name):
        raise AssertionError("a profiler range opened with no profiler recording")

    monkeypatch.setattr(profiling, "_RecordFunctionFast", refuse)
    assert not torch.autograd.profiler._is_profiler_enabled
    for name in SPANS:
        ctx = profiling.span(name)
        assert ctx is profiling.OFF
        with ctx:
            pass


def test_the_flag_alone_decides_and_the_decorator_decides_at_each_call(monkeypatch):
    opened = []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            opened.append(self.name)

        def __exit__(self, *exc):
            return False

    @profiling.spanned(LEARNER_STEP)
    def step(x):
        return x + 1

    monkeypatch.setattr(profiling, "_RecordFunctionFast", Recorder)
    assert step(1) == 2 and opened == []
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    assert isinstance(profiling.span(OPS_SCORE), Recorder)
    assert step(2) == 3 and opened == [LEARNER_STEP]
    assert step.__name__ == "step"


def test_span_names_are_unique_and_of_the_layer_words():
    assert len(set(SPANS)) == len(SPANS)
    for name in SPANS:
        root, layer, stage = name.split(".")
        assert root == "pacoh" and layer in ("learner", "trainer", "ops") and stage


def test_a_fused_svgd_fit_records_its_stages_nested():
    def fit():
        m = svgd()
        assert m._fused_path_ok()
        m.meta_fit(verbose=False, log_period=2, n_iter=2)

    spans = recorded(fit)
    assert spans == [(LEARNER_INIT, None), (LEARNER_PREPARE, LEARNER_INIT),
                     (LEARNER_GATE, None),
                     (LEARNER_META_FIT, None), (LEARNER_GATE, LEARNER_META_FIT),
                     (TRAINER_BUILD, LEARNER_META_FIT), (TRAINER_LAUNCH, LEARNER_META_FIT)]


def test_a_general_svgd_fit_records_its_steps_and_their_ops():
    def fit():
        m = svgd(bandwidth=1.0)  # a fixed bandwidth leaves the fused window
        m.meta_fit(verbose=False, log_period=2, n_iter=2)

    spans = recorded(fit)
    step = [(LEARNER_STEP, LEARNER_META_FIT), (OPS_SCORE, LEARNER_STEP),
            (OPS_TRANSPORT, LEARNER_STEP), (OPS_UPDATE, LEARNER_STEP)]
    assert spans == [(LEARNER_INIT, None), (LEARNER_PREPARE, LEARNER_INIT),
                     (LEARNER_META_FIT, None), (LEARNER_GATE, LEARNER_META_FIT)] + step * 2


def test_an_mlap_eval_records_the_meta_test_its_trainer_and_the_predictive():
    m = GPRegressionMetaLearnedPAC(TRAIN, **MLAP_KW)
    spans = recorded(lambda: m.eval_datasets(TEST, n_iter_meta_test=3))
    assert spans == [(LEARNER_META_TEST, None), (LEARNER_PREPARE, LEARNER_META_TEST),
                     (LEARNER_GATE, LEARNER_META_TEST), (TRAINER_BUILD, LEARNER_META_TEST),
                     (TRAINER_PAGES, LEARNER_META_TEST), (TRAINER_LAUNCH, LEARNER_META_TEST),
                     (LEARNER_EVAL, None), (OPS_PREDICTIVE, LEARNER_EVAL)]


def _svgd_sampled():
    svgd(task_batch_size=2).meta_fit(verbose=False, log_period=2, n_iter=2)


def _vi():
    GPRegressionMetaLearnedVI(TRAIN, svi_batch_size=2, **NETS).meta_fit(
        verbose=False, log_period=2, n_iter=2)


def _map_sampled():
    GPRegressionMetaLearned(TRAIN, task_batch_size=2, **NETS).meta_fit(
        verbose=False, log_period=2, n_iter=2)


def _mlap():
    GPRegressionMetaLearnedPAC(TRAIN, **MLAP_KW).meta_fit(verbose=False, log_period=2, n_iter=2)


def _mlap_meta_test():
    m = GPRegressionMetaLearnedPAC(TRAIN, **MLAP_KW)
    m._meta_test_inference([t[:2] for t in TEST], n_iter=3)


@pytest.mark.parametrize("drive, parent", [
    (_svgd_sampled, LEARNER_META_FIT),  # FusedSVGDTrainer, count pages
    (_vi, None),  # FusedVITrainer, noise pages (the VI learner has no learner spans)
    (_map_sampled, None),  # FusedMAPTrainer, count pages
    (_mlap, LEARNER_META_FIT),  # FusedMLAPTrainer, noise and count pages
    (_mlap_meta_test, LEARNER_META_TEST),  # FusedMLAPMetaTest, noise blocks
], ids=["svgd", "vi", "map", "mlap", "mlap_meta_test"])
def test_each_fused_trainer_records_build_pages_and_launch(drive, parent):
    trainer = [(n, p) for n, p in recorded(drive) if n.startswith("pacoh.trainer.")]
    assert trainer[0] == (TRAINER_BUILD, parent)
    assert trainer[-1] == (TRAINER_LAUNCH, parent)
    assert (TRAINER_PAGES, parent) in trainer[1:-1]
    assert {p for _, p in trainer} == {parent}


def _svgd_state(m):
    state = m.state_dict()
    return [state["particles"], state["opt_state"]["mu"], state["opt_state"]["nu"]]


def _mlap_state(m):
    state = m.state_dict()
    leaves = [np.asarray(v) for v in state["params"]["hyper_post"].values()]
    return leaves + [np.asarray(state["params"][k]) for k in ("raw_noise", "q_means",
                                                               "q_trils")]


@pytest.mark.parametrize("make, state", [
    (lambda: svgd(), _svgd_state),
    (lambda: svgd(bandwidth=1.0), _svgd_state),
    (lambda: GPRegressionMetaLearnedPAC(TRAIN, **MLAP_KW), _mlap_state),
], ids=["svgd_fused", "svgd_general", "mlap_fused"])
def test_a_fit_gives_the_same_bits_with_and_without_a_profiler(make, state):
    plain, traced = make(), make()
    plain.meta_fit(verbose=False, log_period=3, n_iter=3)
    with profile(activities=[ProfilerActivity.CPU]):
        traced.meta_fit(verbose=False, log_period=3, n_iter=3)
    for a, b in zip(state(plain), state(traced), strict=True):
        assert np.array_equal(a, b)


def test_step_timer_reads_a_monotonic_clock(monkeypatch):
    clock = itertools.count(100.0, -1.0)  # a wall clock that steps back at every read
    monkeypatch.setattr(time, "time", lambda: next(clock))
    timer = StepTimer(skip_first=False)
    for _ in range(2):
        with timer.measure(10):
            pass
    assert all(seconds >= 0 for _, seconds in timer.records)
    assert timer.steps_per_sec > 0
