"""Device meshes and the task-sharded SVGD step (counterpart of
meta_learning_pacoh_tpu/parallel/mesh.py).

The JAX package is single-controller: one process sees every device as one
``Mesh`` and GSPMD inserts the collectives. PyTorch runs one process a
device, so the port keeps the JAX names and semantics and adopts torch's
process model:

  - a device of the JAX mesh is a rank of a process group;
  - ``initialize_distributed`` is ``init_process_group`` (NCCL for the card,
    gloo for the CPU);
  - a mesh is a ``DeviceMesh`` with the JAX axis names, ``("task",)`` or
    ``("task", "particle")``;
  - the collectives are explicit calls on the group of a mesh dimension: the
    task axis's ``all_reduce`` sums the per-task terms of a score or a
    gradient, the particle axis's ``all_gather`` assembles the particles
    for the Stein transport. None is ever replaced by a local computation,
    also on a mesh of one rank.

A task-sharded learner keeps the rank's contiguous slice of the task axis
(``shard_task_batch``), as GSPMD places a ``PartitionSpec("task")`` array.
"""

import torch
import torch.distributed as dist

from meta_learning_pacoh_torch.models.random_gp import meta_log_prob
from meta_learning_pacoh_torch.ops import cuda
from meta_learning_pacoh_torch.ops.svgd import svgd_phi


def _device_type(device):
    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: a mesh lives on the card by default; "
                           "pass device='cpu' for a gloo mesh on the CPU")
    return device_type


def _backend(device_type):
    return "nccl" if device_type == "cuda" else "gloo"


def initialize_distributed(coordinator_address=None, num_processes=None, process_id=None,
                           local_device_ids=None, device="cuda"):
    """Multi-process entry point: join this process to the process group that
    every mesh of the program spans.

    Call it once a process before building a mesh. ``coordinator_address``
    is rank 0's "host:port" (the TCP rendezvous of ``init_process_group``),
    or a whole init-method URL such as "file:///path" or "tcp://host:port";
    ``num_processes`` the world size, ``process_id`` this process's rank.
    The group runs NCCL on the card and gloo with ``device="cpu"``.

    torch runs one device a process: ``local_device_ids`` names the one CUDA
    device of this rank, and more than one id raises (the JAX package lets a
    process own several). Single-process path: with no coordinator and at
    most one process this is a no-op, as in the JAX package; ``make_mesh``
    then builds a one-rank group of its own.
    """
    if coordinator_address is None and (num_processes is None or num_processes <= 1):
        return  # one process: nothing to rendezvous
    device_type = _device_type(device)
    if local_device_ids is not None:
        ids = [local_device_ids] if isinstance(local_device_ids, int) else list(local_device_ids)
        if len(ids) != 1:
            raise ValueError("torch runs one device a process: pass one local device id, "
                             f"got {ids}")
        if device_type != "cuda":
            raise ValueError("local_device_ids names a CUDA device; a CPU rank has none")
        torch.cuda.set_device(ids[0])
    if coordinator_address is None:
        raise ValueError("several processes need a coordinator_address to meet at")
    init_method = (coordinator_address if "://" in coordinator_address
                   else "tcp://" + coordinator_address)
    dist.init_process_group(_backend(device_type), init_method=init_method,
                            world_size=num_processes, rank=process_id)


def _ensure_group(device_type):
    """The default process group; in a process that has none, a one-rank
    group on an in-process store (a single-process user's mesh)."""
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(torch.cuda.current_device())
        dist.init_process_group(_backend(device_type), store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_world_size()


def _device_mesh(n_devices, names_of, device):
    from torch.distributed.device_mesh import DeviceMesh

    device_type = _device_type(device)
    world = _ensure_group(device_type)
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices needs 1 to {world} ranks")
    shape, names = names_of(n)
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=names)


def make_mesh(n_devices=None, particle_parallel=False, device="cuda"):
    """1-D ``("task",)`` mesh over the first ``n_devices`` ranks (default:
    all), or 2-D ``("task", "particle")`` of shape (n // 2, 2) when asked
    and n >= 4 and even. A CUDA (NCCL) mesh unless ``device="cpu"`` (gloo);
    without a process group, a one-rank group of this process."""

    def names_of(n):
        if particle_parallel and n >= 4 and n % 2 == 0:
            return (n // 2, 2), ("task", "particle")
        return (n,), ("task",)

    return _device_mesh(n_devices, names_of, device)


def make_seed_mesh(n_devices=None, device="cuda"):
    """1-D ``("seed",)`` mesh for sharding seed-parallel fits."""
    return _device_mesh(n_devices, lambda n: ((n,), ("seed",)), device)


# ------------------------------------------------------------ mesh helpers
def axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_rank(mesh, axis):
    """This rank's coordinate on the mesh axis ``axis``."""
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis):
    return mesh.get_group(axis)


def rank_device(mesh):
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_mesh_device(mesh, device):
    """Raise unless ``device`` is of the mesh's device type."""
    if torch.device(device).type != mesh.device_type:
        raise ValueError(f"the learner's device {device} differs from its mesh's "
                         f"device type {mesh.device_type!r}")


def all_gather(t, group):
    """[D, *t.shape]: every rank's ``t`` stacked in group-rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def broadcast_(t, src, group):
    """Broadcast ``t`` in place from the group's rank ``src``."""
    dist.broadcast(t, src=dist.get_global_rank(group, src), group=group)
    return t


def all_reduce_(tensors, group):
    """Sum a list of tensors over ``group`` in place, in one collective."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
        t.copy_(part.reshape(t.shape))
    return tensors


def shard_rows(mesh, n, axis="task"):
    """The slice of the n rows of ``axis`` that this rank holds; raises
    where n does not divide the axis (``jax.device_put`` of a
    ``NamedSharding`` refuses such an array)."""
    d = axis_size(mesh, axis)
    if n % d:
        raise ValueError(f"the global size {n} of the {axis!r} axis should be divisible "
                         f"by the mesh's {d} ranks")
    per = n // d
    r = axis_rank(mesh, axis)
    return slice(r * per, (r + 1) * per)


def shard_task_batch(mesh, X, Y, mask):
    """This rank's contiguous slice of the task axis of the padded
    [T, N, ...] task tensors, on the rank's device."""
    rows = shard_rows(mesh, X.shape[0])
    device = rank_device(mesh)
    return tuple(torch.as_tensor(a)[rows].to(device) for a in (X, Y, mask))


def task_sizes(mesh, mask):
    """[T] real-point counts of every task of the mesh, from this rank's
    mask [T / D, N] (one all_gather on the task axis)."""
    return all_gather(torch.sum(mask, dim=-1), axis_group(mesh, "task")).reshape(-1)


# ------------------------------------------------------ sharded SVGD step
def build_svgd_parallel_step(hyper_prior, prior_factor, opt, mesh, kernel="RBF",
                             bandwidth=None):
    """Full-batch SVGD training step with the tasks sharded over the mesh.

    Returns (step_fn, place). ``opt`` is the learning rate of the Adam
    update (the port's counterpart of ``optax.adam(lr)``).
    ``place(particles, opt_state, X, Y, mask)`` lays the state out: the
    particles [K, P] and their Adam moments split on the particle axis
    where the mesh has one (else whole on every rank), the tasks on the
    task axis; ``opt_state`` is None (a fresh Adam state) or
    {"mu", "nu", "count"}. ``step_fn(particles, opt_state, X, Y, mask)``
    updates the placed state in place and returns it: each rank takes the
    score of its particles on its own tasks (the hyper-prior term once, on
    the task axis's first rank), an ``all_reduce`` over the task axis sums
    those scores, the particles and scores are gathered over the particle
    axis for phi (``ops.svgd.svgd_phi``: the Stein kernel K1 on the card),
    and each rank applies Adam to its own particles.
    """
    has_particle_axis = "particle" in mesh.mesh_dim_names
    task_group = axis_group(mesh, "task")
    lead = axis_rank(mesh, "task") == 0
    lr = float(opt)

    def particle_rows(k):
        if not has_particle_axis:
            return slice(0, k)
        return shard_rows(mesh, k, "particle")

    def place(particles, opt_state, X, Y, mask):
        device = rank_device(mesh)
        particles = torch.as_tensor(particles).to(device)
        rows = particle_rows(particles.shape[0])
        if opt_state is None:
            opt_state = {"mu": torch.zeros_like(particles), "nu": torch.zeros_like(particles),
                         "count": 0}
        opt_state = {"mu": torch.as_tensor(opt_state["mu"]).to(device)[rows].clone(),
                     "nu": torch.as_tensor(opt_state["nu"]).to(device)[rows].clone(),
                     "count": int(opt_state["count"])}
        return (particles[rows].clone(), opt_state) + shard_task_batch(mesh, X, Y, mask)

    def step_fn(particles, opt_state, X, Y, mask):
        sizes = task_sizes(mesh, mask)
        part = particles.detach().requires_grad_(True)
        log_prob = meta_log_prob(hyper_prior, prior_factor, part, X, Y, mask,
                                 task_sizes=sizes, with_prior=lead)
        (score,) = torch.autograd.grad(log_prob.sum(), part)
        all_reduce_([score], task_group)
        with torch.no_grad():
            if has_particle_axis:
                group = axis_group(mesh, "particle")
                every = all_gather(particles, group).reshape(-1, particles.shape[-1])
                phi = svgd_phi(every, all_gather(score, group).reshape(every.shape),
                               kernel=kernel, bandwidth=bandwidth)
                phi = phi[particle_rows(every.shape[0])]
            else:
                phi = svgd_phi(particles, score, kernel=kernel, bandwidth=bandwidth)
            opt_state["count"] += 1
            cuda.adam_step_(particles, opt_state["mu"], opt_state["nu"], -phi,
                            opt_state["count"], lr)
        return particles, opt_state

    return step_fn, place
