"""Staircase lr schedule and its launch plan (counterpart of meta_learning_pacoh_tpu/ops/pallas/launch_sched.py).

The reference's StepLR schedule changes the Adam learning rate only at
global-step multiples of ``LR_TRANSITION_STEPS``: the lr in effect at 0-based
global step s is ``lr0 * decay ** (s // transition)``, as optax evaluates
``exponential_decay(..., staircase=True)`` at the pre-increment count. The
general step reads ``staircase_lr`` every step; the fused training kernel
takes the lr as one scalar per launch, so ``staircase_launches`` splits a
chunk so that no launch crosses a boundary. The lr is a function of the
global step alone, so any chunking gives the same trajectory.

The JAX module's ``bump_counts`` is not needed here: the port's optimizer
state is a plain dict whose one step count the learner advances itself.

A fused kernel's sampled task batch comes as count pages (``count_pages``):
per step, how often each task was drawn, from the learner's own draws.
"""

import torch

# StepLR step size of the reference. Module-level so tests can shrink it to
# cross boundaries cheaply; read at call time.
LR_TRANSITION_STEPS = 1000


def staircase_lr(lr0, lr_decay, step, transition=None):
    """The lr in effect at 0-based global step ``step`` under the staircase."""
    if lr_decay >= 1.0:
        return float(lr0)
    t = LR_TRANSITION_STEPS if transition is None else int(transition)
    return float(lr0) * float(lr_decay) ** (int(step) // t)


def staircase_launches(step0, n_steps, max_launch, lr_decay=1.0, transition=None):
    """Yield ``(launch_step0, sub_steps)`` covering [step0, step0 + n_steps).

    Each launch is capped at ``max_launch`` and, when ``lr_decay < 1``, never
    crosses a staircase boundary, so one lr per launch is exact.
    """
    t = LR_TRANSITION_STEPS if transition is None else int(transition)
    step0, n_steps = int(step0), int(n_steps)
    if n_steps > 0 and int(max_launch) < 1:
        raise ValueError(f"staircase_launches: max_launch must be >= 1, got {max_launch}")
    done = 0
    while done < n_steps:
        s = step0 + done
        sub = min(int(max_launch), n_steps - done)
        if lr_decay < 1.0:
            sub = min(sub, t - (s % t))
        yield s, sub
        done += sub


def count_pages(task_draw, n_tasks, step0, n_steps):
    """[n_steps, T] float32 draw counts of global steps step0 .. step0 + n_steps - 1,
    from ``task_draw(step)``, the task indices of one step (a CPU tensor)."""
    pages = torch.zeros(n_steps, n_tasks, dtype=torch.float32)
    for i in range(n_steps):
        pages[i] = torch.bincount(task_draw(step0 + i), minlength=n_tasks)
    return pages
