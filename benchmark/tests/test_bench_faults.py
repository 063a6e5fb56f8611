"""A run with its timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
with one fault planted in the program: a step that returns its state
unchanged, a launch whose later steps keep its first step's count, half of
the batch left out (the mean taken over the rest), an answer altered where
it is produced, for every task or for a quarter of them. The limits are the
cells' own. The fit cells' faults run on the CPU at small sizes; the
meta-test cell's need its own sizes on the card, where the tasks its check
compares exist (a meta-test fitted for fewer steps leaves every task's
answer to float32 rounding, and the check then compares none). One chip
runs every cell, so no exchange between chips can be left out.
"""

import pytest

from benchmark import harness

FIT = {"config": {"kwargs": {"num_iter_fit": 4}}, "traffic": {"n_tasks": 6}}


def run(cell, overrides, seed=2 ** 31 + 77, device="cpu"):
    return harness.run_cell(cell, seed, 0.2, False, device=device, overrides=overrides)


def test_a_fit_step_that_returns_its_state_unchanged_is_not_correct(monkeypatch):
    from meta_learning_pacoh_torch.algos.pacoh_svgd import GPRegressionMetaLearnedSVGD

    def unchanged(self, chunk):
        self._step_count += chunk
        self._adam_count += chunk

    monkeypatch.setattr(GPRegressionMetaLearnedSVGD, "_fused_run_chunk", unchanged)
    assert not run("svgd_sin320_fit", FIT)["correct"]


def test_a_fit_on_half_of_the_batch_is_not_correct(monkeypatch):
    from meta_learning_pacoh_torch.algos.pacoh_svgd import GPRegressionMetaLearnedSVGD

    chunk_of = GPRegressionMetaLearnedSVGD._fused_run_chunk

    def half(self, chunk):
        if self._fused is None:  # the kernel's batch: the first half of the tasks
            t = self.n_tasks // 2
            self.X, self.Y, self.mask = self.X[:t], self.Y[:t], self.mask[:t]
            self.n_tasks = self.task_batch_size = t
        chunk_of(self, chunk)

    monkeypatch.setattr(GPRegressionMetaLearnedSVGD, "_fused_run_chunk", half)
    assert not run("svgd_sin320_fit", FIT)["correct"]


def test_a_launch_whose_later_steps_keep_its_first_step_count_is_not_correct(monkeypatch):
    from meta_learning_pacoh_torch.ops.cuda.fused_svgd_kernel import FusedSVGDTrainer

    train = FusedSVGDTrainer.train_fn

    def stuck(*args, n_steps, **kwargs):  # Adam's bias corrections stay at the launch's step0
        args = list(args)
        counts = args[10] if len(args) > 10 else kwargs.pop("counts", None)
        for i in range(n_steps):
            step = None if counts is None else counts[i:i + 1]
            train(*args[:10], step, n_steps=1, **kwargs)

    monkeypatch.setattr(FusedSVGDTrainer, "train_fn", staticmethod(stuck))
    result = run("svgd_sin320_fit", FIT)
    assert not result["correct"]
    change = result["checks"]["change_gap"]
    assert change["value"] > change["limit"], "step 3, inside the launch, is the one at fault"


@pytest.mark.gpu
def test_a_prior_fit_that_returns_its_state_unchanged_is_not_correct(card, monkeypatch):
    import torch

    from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import FusedMLAPTrainer

    def unchanged(self, params, mu, nu, step0, n_steps):
        zero = torch.zeros((), device=params["raw_noise"].device)
        return zero, zero, {}

    monkeypatch.setattr(FusedMLAPTrainer, "launch", unchanged)
    assert not run("mlap_sin20_metatest", {}, device=card)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [2 ** 31 + 77, 2 ** 31 + 78, 2 ** 31 + 79])
def test_a_prior_fit_on_half_of_the_batch_is_not_correct(card, monkeypatch, seed):
    from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import FusedMLAPTrainer

    count_pages = FusedMLAPTrainer.count_pages

    def half(self, step0, n_steps):  # the later half of the tasks' draws left out,
        pages = count_pages(self, step0, n_steps)  # the rest weighted up to the batch
        kept = pages.clone()
        kept[:, pages.shape[1] // 2:] = 0.0
        return kept * (pages.sum(1, keepdim=True) / kept.sum(1, keepdim=True))

    monkeypatch.setattr(FusedMLAPTrainer, "count_pages", half)
    assert not run("mlap_sin20_metatest", {}, seed, device=card)["correct"]


@pytest.mark.gpu
def test_a_meta_test_that_returns_its_state_unchanged_is_not_correct(card, monkeypatch):
    from meta_learning_pacoh_torch.ops.cuda.fused_mlap_kernel import FusedMLAPMetaTest

    monkeypatch.setattr(FusedMLAPMetaTest, "run", lambda self, params, n, eps_block: None)
    assert not run("mlap_sin20_metatest", {}, device=card)["correct"]


@pytest.mark.gpu
def test_a_meta_test_answering_half_of_the_tasks_is_not_correct(card, monkeypatch):
    from meta_learning_pacoh_torch.algos.pacoh_mlap import GPRegressionMetaLearnedPAC

    batch_eval = GPRegressionMetaLearnedPAC._run_batch_eval

    def half(self, task_state, TX, TY):  # the first half's answers, their mean taken
        t = TX.shape[0] // 2
        state = {k: v if k == "theta_agg" else v[:t] for k, v in task_state.items()}
        return batch_eval(self, state, TX[:t], TY[:t])

    monkeypatch.setattr(GPRegressionMetaLearnedPAC, "_run_batch_eval", half)
    assert not run("mlap_sin20_metatest", {}, device=card)["correct"]


@pytest.mark.gpu
def test_a_meta_test_whose_answers_are_altered_is_not_correct(card, monkeypatch):
    from meta_learning_pacoh_torch.algos.pacoh_mlap import GPRegressionMetaLearnedPAC

    predictive = GPRegressionMetaLearnedPAC._predictive

    def altered(self, task_state, TX):  # every predictive mean moved by 1e-3
        mean, cov = predictive(self, task_state, TX)
        return mean + 1e-3, cov

    monkeypatch.setattr(GPRegressionMetaLearnedPAC, "_predictive", altered)
    assert not run("mlap_sin20_metatest", {}, device=card)["correct"]


@pytest.mark.gpu
def test_a_meta_test_whose_answers_are_altered_on_some_tasks_is_not_correct(card, monkeypatch):
    from benchmark.drivers.meta_test import SOME
    from meta_learning_pacoh_torch.algos.pacoh_mlap import GPRegressionMetaLearnedPAC

    predictive = GPRegressionMetaLearnedPAC._predictive

    def altered(self, task_state, TX):  # a quarter of the tasks' means moved by 1e-3
        mean, cov = predictive(self, task_state, TX)
        mean = mean.clone()
        mean[::SOME] += 1e-3
        return mean, cov

    monkeypatch.setattr(GPRegressionMetaLearnedPAC, "_predictive", altered)
    result = run("mlap_sin20_metatest", {}, device=card)
    assert not result["correct"]
    assert result["checks"]["meta_rmse_med_gap"]["value"] <= \
        result["checks"]["meta_rmse_med_gap"]["limit"], "a median alone would miss it"
