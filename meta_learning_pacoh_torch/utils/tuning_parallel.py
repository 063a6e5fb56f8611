"""Hyper-parallel trial execution: K tuning trials in one stacked fit
(counterpart of meta_learning_pacoh_tpu/utils/tuning_parallel.py).

The reference ran tuning trials concurrently on a Ray cluster (reference:
custom_tune/trial_runner.py:80-138, one Ray actor per trial). Here, as in
the JAX package, the trial axis becomes a tensor axis, as
``parallel/seed_parallel.py`` does for seeds: K learners that differ only
in continuous hyperparameters (lr, weight decay, prior_factor, bandwidth)
are stacked, each trial's hyperparameters ride the stack as [K] tensors
(the JAX package moves them into optax's state with ``inject_hyperparams``;
here the Adam(W) update takes them broadcast), and the learner's own
stacked step advances all K trials at once.

Static and shape hyperparameters (feature_dim, task_batch_size,
num_particles) cannot ride a stack: callers group suggestions by static
configuration and stack within each group (the ``batch_trial_fn`` contract
of ``utils/tuning.tune_run``). The JAX package memoizes one compiled step a
group (``jit_cache.shared``); here a group's shared static configuration
is checked by equality. With ``mesh=``, the trial axis is padded to the
mesh axis's size (the last trial again) and split over its ranks, as
``parallel.fit_models_parallel`` splits seeds; the axis is "trial" where
the mesh has one, else its first.
"""

from meta_learning_pacoh_torch.parallel.seed_parallel import check_group, fit_stacked


def _assert_common(models, free):
    """The checks of every hyper-parallel fit, as the JAX package's: one
    class and one static configuration but the trial hyperparameters
    ``free``, Adam at a constant lr, all at step 0."""
    check_group(models, free=free)
    m0 = models[0]
    assert all(m._optimizer_name == "Adam" for m in models)
    assert all(m._lr_decay == 1.0 for m in models), (
        "lr_decay schedules carry per-step state; not stacked over trials")
    assert all(m._step_count == 0 for m in models)
    return m0


def _fit(models, n_iter, log_period, free, mesh):
    m0 = _assert_common(models, free)
    axis = None
    if mesh is not None:
        names = mesh.mesh_dim_names
        axis = "trial" if "trial" in names else names[0]
    return fit_stacked(models, m0.num_iter_fit if n_iter is None else n_iter,
                       log_period=log_period, mesh=mesh, axis=axis)


def fit_map_hyper_parallel(models, n_iter=None, log_period=5000, mesh=None):
    """Meta-fit K GPRegressionMetaLearned models that differ only in
    lr_params / weight_decay, in one stacked fit.

    Requirements: identical static configuration (cfg, learning_mode, task
    batch, data shapes), optimizer 'Adam', lr_decay == 1.0, all at step 0.
    The models' parameters and AdamW moments are updated in place (as
    meta_fit's general step would, up to float reassociation), so continued
    meta_fit and state_dict keep working.
    """
    assert type(models[0]).__name__ == "GPRegressionMetaLearned", (
        "fit_map_hyper_parallel takes PACOH-MAP learners")
    return _fit(models, n_iter, log_period, ("lr_params", "weight_decay"), mesh)


def fit_svgd_hyper_parallel(models, n_iter=None, log_period=5000, mesh=None):
    """Meta-fit K GPRegressionMetaLearnedSVGD models that differ only in
    lr / prior_factor / bandwidth, in one stacked fit.

    bandwidth: either all None (the median heuristic: one K1 launch a step
    for all trials) or all numeric (the plain transport, one bandwidth a
    trial); a mixed batch raises (tune_run's batch-failure fallback then
    runs the trials sequentially).
    """
    m0 = models[0]
    assert type(m0).__name__ == "GPRegressionMetaLearnedSVGD"
    if any(m.bandwidth is None for m in models):
        assert all(m.bandwidth is None for m in models), (
            "mixed None/numeric bandwidths cannot share one stacked step")
    return _fit(models, n_iter, log_period, ("_lr", "prior_factor", "bandwidth"), mesh)


def fit_vi_hyper_parallel(models, n_iter=None, log_period=5000, mesh=None):
    """Meta-fit K GPRegressionMetaLearnedVI models that differ only in
    lr / prior_factor, in one stacked fit."""
    assert type(models[0]).__name__ == "GPRegressionMetaLearnedVI"
    return _fit(models, n_iter, log_period, ("_lr", "prior_factor"), mesh)


def fit_hyper_parallel(models, n_iter=None, log_period=5000, mesh=None):
    """Dispatch a homogeneous trial batch to the learner's hyper-parallel
    fit. Raises for learner families without one (callers fall back to
    sequential trials)."""
    name = type(models[0]).__name__
    fits = {
        "GPRegressionMetaLearned": fit_map_hyper_parallel,
        "GPRegressionMetaLearnedSVGD": fit_svgd_hyper_parallel,
        "GPRegressionMetaLearnedVI": fit_vi_hyper_parallel,
    }
    if name not in fits:
        raise NotImplementedError(f"hyper-parallel trials cover MAP/SVGD/VI; got {name}")
    return fits[name](models, n_iter=n_iter, log_period=log_period, mesh=mesh)


def run_trial_batch(configs, build_model_fn, eval_fn, n_iter,
                    static_keys=("feature_dim", "task_batch_size"), mesh=None,
                    log_period=5000):
    """Execute a batch of tuning trials (MAP / SVGD / VI): group configs by
    their static (shape-changing) keys, hyper-parallel-fit each group of
    size >= 2, run singletons sequentially, and return results in input
    order.

    build_model_fn(config) -> learner; eval_fn(model) -> metrics dict.
    """
    groups = {}
    for i, c in enumerate(configs):
        groups.setdefault(tuple(c.get(k) for k in static_keys), []).append(i)
    results = [None] * len(configs)
    for idx in groups.values():
        models = [build_model_fn(configs[i]) for i in idx]
        if len(models) >= 2:
            fit_hyper_parallel(models, n_iter=n_iter, mesh=mesh, log_period=log_period)
        else:
            models[0].meta_fit(verbose=False, log_period=n_iter, n_iter=n_iter)
        for i, m in zip(idx, models):
            results[i] = eval_fn(m)
    return results


# the JAX package's alias (its MAP-only name)
run_map_trial_batch = run_trial_batch
