"""Data-parallel Monte-Carlo over ranks on ``torch.distributed``.

Counterpart of ``qkd_ldpc_v_tpu/parallel/driver.py``, the replacement for
the reference's thread pool over trials (src/simulation.cpp:693-768).

Design:
  * one rank per device, torch's idiom: the JAX package's one-process mesh
    of n devices becomes n ranks, and its multi-host mesh the same across
    hosts. A ``DataMesh`` names the rank, the world size, the rank's device
    and its process group; a world of one rank needs no group, and its
    collectives are the identity;
  * each rank runs the single-rank chunk step (``simulation.ChunkStep``) on
    its share of every chunk, through the kernels ``select_engine`` picks;
    the decode is batch-local and needs no communication;
  * frames per rank: ``local = ceil(batch / world)``. Engines with an mc
    mode (``qc``, ``qc_stream``, ``generic``) shard by frame offset: rank r
    calls the mc mode with the chunk's own seed and first frame
    ``r * local``, the counterpart of JAX's ``fold_in`` for a counter-based
    generator, so a sharded run decodes the single-rank run's frames at any
    world size and its CSV equals that run's apart from throughput. Paths
    that draw keys from the torch generator (the ``stream`` and ``xla``
    engines, rate-adaptive runs) seed rank r's generator with
    ``channel.rank_chunk_seed``; as in JAX, their results depend on the
    world size;
  * statistics come back gathered per frame (``all_gather`` in rank order;
    every rank returns the same ``SimResult`` apart from throughput) or
    reduced on the device to six scalars in float64 (``psum_stats``), frames
    at global index >= ``take`` sliced off or masked, as in JAX;
  * ``edge_sharded_decoder``: the generic decoder with its check-major
    message rows split over ranks at check boundaries.

No fallback: a mesh on ``cuda`` without a card raises, no rank catches
another's failure, and ``initialize_distributed`` bounds the group's
timeout, so a rank that dies makes the others fail rather than hang.

Spans (``utils.span``): a step call is ``parallel.step``; inside it the
device synchronize after the rank's decode is ``parallel.sync`` and the
statistics' collective ``parallel.reduce`` (``psum_stats`` or
``_gather_frames``), whose blocking waits and host reads are each
``parallel.wait``.
"""

from __future__ import annotations

import os
import socket
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from qkd_ldpc_v_tpu_torch.config import Config, DecodingAlgorithm
from qkd_ldpc_v_tpu_torch.models.hmatrix import HMatrix
from qkd_ldpc_v_tpu_torch.ops.decoders import check_row_edges, make_decoder
from qkd_ldpc_v_tpu_torch.simulation import ChunkStep, _synchronize
from qkd_ldpc_v_tpu_torch.utils import PlanCache, span

# Seconds a collective of a group made by ``initialize_distributed`` waits
# for a rank before it fails.
DEFAULT_TIMEOUT_S = 300.0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the default process group: ``dist.init_process_group(backend,
    init_method="tcp://" + coordinator_address, world_size=num_processes,
    rank=process_id)`` with a bounded ``timeout_s``. One process is a no-op.

    Arguments left out are read from torchrun's environment (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``), as ``jax.distributed``
    reads its cluster's. The backend is explicit: ``"nccl"`` by default
    where CUDA is available, else ``"gloo"``; pass ``"gloo"`` for CUDA
    ranks that share one card (NCCL refuses two ranks on one device)."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=timedelta(seconds=timeout_s))


@dataclass(frozen=True)
class DataMesh:
    """One rank's view of the data mesh: its rank and the world size in
    ``group`` (None: the default group, or no group in a world of one), and
    the device it decodes on."""

    rank: int
    world_size: int
    device: torch.device
    group: Optional[object] = None


def make_data_mesh(device=None, group=None) -> DataMesh:
    """This process's ``DataMesh`` in ``group`` (default: the default group
    if one is initialised, else a world of one rank).

    ``device`` is explicit, or ``cuda:{local_rank % device_count}`` with
    ``local_rank`` from torchrun's ``LOCAL_RANK`` (else the rank); the CPU
    only when asked. A CUDA device without a card raises; so do an NCCL
    group on the CPU and an NCCL group that would put two of its ranks on
    one card (NCCL would fail or hang there)."""
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        if rank < 0:
            raise ValueError("this process is not a member of the group")
    else:
        if group is not None:
            raise ValueError("a group was given, but no process group is "
                             "initialised")
        rank, world = 0, 1
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device}: no CUDA device is available "
                               "(pass device='cpu' for CPU ranks)")
        if device.index is None:
            device = torch.device("cuda",
                                  local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if world > 1 and dist.get_backend(group) == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL group cannot reduce on {device}")
        _refuse_shared_cards(device, group)
    return DataMesh(rank, world, device, group)


def _refuse_shared_cards(device: torch.device, group) -> None:
    """Raise where two ranks of an NCCL ``group`` would use one card: each
    rank posts its host and device index to the group's store."""
    store = dist.distributed_c10d._get_default_store()
    members = dist.get_process_group_ranks(group or dist.group.WORLD)
    me = dist.get_rank()
    # The n-th mesh a rank makes posts under n, so no rank reads another's
    # post of an earlier mesh.
    n = store.add(f"qkd_data_mesh/{me}/meshes", 1)
    store.set(f"qkd_data_mesh/{me}/{n}",
              f"{socket.gethostname()}/{device.index}")
    seen = {}
    for r in members:
        other = store.get(f"qkd_data_mesh/{r}/{n}").decode()
        if other in seen:
            raise ValueError(
                f"ranks {seen[other]} and {r} would share {other} in an NCCL "
                "group: give each rank its own card, or use gloo")
        seen[other] = r


def _all_reduce(t: torch.Tensor, op, mesh: DataMesh):
    """Start an all-reduce of ``t`` in place over the mesh; returns the work
    to wait on (None in a world of one rank, where ``t`` is the result)."""
    if mesh.world_size > 1:
        return dist.all_reduce(t, op=op, group=mesh.group, async_op=True)
    return None


def _wait(work) -> None:
    if work is not None:
        with span("parallel.wait"):
            work.wait()


def psum_stats(syndromes_match: torch.Tensor, keys_match: torch.Tensor,
               iterations: torch.Tensor,
               mesh: DataMesh) -> Tuple[float, float, float, float, float,
                                        float]:
    """The six statistics of the mesh's frames, reduced on the device:
    ``(n_success_dec, n_success_ldpc, iter_sum, iter_m2, iter_min,
    iter_max)``, the JAX package's ``psum_stats`` through ``all_reduce``
    (SUM of the sums; SUM of ``iter_m2``, which needs the global mean; MAX
    of the negated minimum and of the maximum, started with the first), in
    float64 on every backend, so counts and iteration sums are exact at any
    world size. ``iter_m2`` is the sum of squared deviations about the
    global mean (Chan's form); ``iter_min`` is 2**31 - 1 and ``iter_max`` -1
    where no frame converged. Each rank passes its own frames and gets the
    same six Python floats."""
    dev = syndromes_match.device
    ok = syndromes_match.to(torch.bool)
    okf = ok.to(torch.float64)
    it = iterations.to(torch.float64)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    sums = torch.stack([okf.sum(), (okf * keys_match.to(torch.float64)).sum(),
                        torch.where(ok, it, zero).sum()])
    summing = _all_reduce(sums, dist.ReduceOp.SUM, mesh)
    big = torch.full((1,), float(np.iinfo(np.int32).max), dtype=torch.float64,
                     device=dev)
    low = torch.cat([torch.where(ok, it, big), big]).min()
    high = torch.cat([torch.where(ok, it, -1.0), -torch.ones_like(big)]).max()
    ends = torch.stack([-low, high])
    extremes = _all_reduce(ends, dist.ReduceOp.MAX, mesh)
    _wait(summing)
    mean = sums[2] / torch.clamp(sums[0], min=1.0)
    deviation = it - mean
    m2 = torch.where(ok, deviation * deviation, zero).sum().reshape(1)
    _wait(_all_reduce(m2, dist.ReduceOp.SUM, mesh))
    _wait(extremes)
    with span("parallel.wait"):
        n_dec, n_ldpc, it_sum = sums.tolist()
        return (n_dec, n_ldpc, it_sum, float(m2), -float(ends[0]),
                float(ends[1]))


def _gather_frames(syndromes_match: torch.Tensor, keys_match: torch.Tensor,
                  iterations: torch.Tensor, mesh: DataMesh):
    """Every rank's per-frame outcomes in rank order, on the host:
    ``(syndromes_match bool, keys_match bool, iterations int32)`` NumPy
    arrays of ``world_size * local`` frames. One ``all_gather`` (the list
    form, which gloo and NCCL both take) of the three packed as int32."""
    packed = torch.stack([syndromes_match.to(torch.int32),
                          keys_match.to(torch.int32),
                          iterations.to(torch.int32)])
    if mesh.world_size > 1:
        parts = [torch.empty_like(packed) for _ in range(mesh.world_size)]
        dist.all_gather(parts, packed, group=mesh.group)
        packed = torch.cat(parts, dim=1)
    with span("parallel.wait"):
        host = packed.cpu().numpy()
    return host[0].astype(bool), host[1].astype(bool), host[2]


def sharded_step(
    matrix: HMatrix,
    cfg: Config,
    global_batch: int,
    mesh: DataMesh,
    reduce_stats: bool = False,
) -> Callable:
    """The chunk step of one rank of ``mesh``: it decodes frames
    ``rank * local .. (rank + 1) * local - 1`` of each chunk of
    ``global_batch`` frames (``local = global_batch / world``; callers round
    up, see ``mesh_step_factory``), through ``simulation.ChunkStep`` (see
    the module docstring for how a rank draws its frames).

    ``step(args, chunk_index, take)`` returns, gathered, every rank's
    per-frame outcomes in rank order, on the host (the caller keeps the
    first ``take``), or with ``reduce_stats`` the six ``psum_stats``
    scalars of the chunk's first ``take`` frames, the surplus masked on the
    device. The step carries ``reduces``, ``device``, and ``times``: per
    call the rank's (decode seconds, collective seconds), the decode ending
    at a device synchronize."""
    world = mesh.world_size
    if global_batch % world:
        raise ValueError(
            f"global batch {global_batch} not divisible by world size {world}")
    local = global_batch // world
    first = mesh.rank * local
    chunk = ChunkStep(matrix, cfg, mesh.device, local, frame0=first,
                      rank=mesh.rank)
    times = []

    def step(args, chunk_index, take):
        with span("parallel.step"):
            t0 = time.perf_counter()
            conv, keys, iters = chunk.decode(args, chunk_index)
            with span("parallel.sync"):
                _synchronize(mesh.device)
            with span("parallel.reduce"):
                t1 = time.perf_counter()
                if reduce_stats:
                    index = torch.arange(first, first + local,
                                         device=conv.device)
                    out = psum_stats(conv & (index < take), keys, iters,
                                     mesh)
                else:
                    out = _gather_frames(conv, keys, iters, mesh)
                times.append((t1 - t0, time.perf_counter() - t1))
            return out

    step.reduces = reduce_stats
    step.device = mesh.device
    step.times = times
    return step


def mesh_step_factory(mesh: DataMesh, reduce_stats: bool = False) -> Callable:
    """A ``step_factory`` for ``simulation.run_combination`` and
    ``qkd_ldpc_batch_simulation`` that splits each chunk over ``mesh``:
    ``factory(matrix, cfg, batch)`` rounds the batch up to a multiple of the
    world size and returns ``sharded_step``'s step, cached per matrix and
    config. The factory carries the mesh's ``rank`` (rank 0 alone writes a
    checkpoint)."""
    cache = PlanCache()

    def factory(matrix: HMatrix, cfg: Config, batch: int) -> Callable:
        world = mesh.world_size
        global_batch = -(-batch // world) * world
        key = (cfg, global_batch, reduce_stats)
        fn = cache.get(matrix, extra=key)
        if fn is None:
            fn = sharded_step(matrix, cfg, global_batch, mesh,
                              reduce_stats=reduce_stats)
            cache.put(matrix, fn, extra=key)
        return fn

    factory.rank = mesh.rank
    return factory


def check_ranges(layout, world: int):
    """The internal checks of each rank, ``[(lo, hi)]`` in rank order:
    contiguous, cut at check boundaries so each rank holds about
    ``E / world`` check-major edges."""
    degrees = np.concatenate(
        [np.full(g.count, g.degree, dtype=np.int64) for g in layout.check_groups])
    cum = np.concatenate([[0], np.cumsum(degrees)])
    bounds = [int(np.searchsorted(cum, k * layout.num_edges / world))
              for k in range(world)] + [layout.num_checks]
    return [(bounds[k], bounds[k + 1]) for k in range(world)]


def edge_sharded_decoder(
    layout,
    algorithm: DecodingAlgorithm,
    max_iterations: int,
    mesh: DataMesh,
    dtype: torch.dtype = torch.float32,
) -> Callable:
    """The generic decoder (``ops/decoders.py``, no message clamp) with its
    ``[E, B]`` message state split over ``mesh``'s ranks, the counterpart
    of JAX's edge-sharded decoder (SURVEY.md §5).

    Each rank holds the check-major message rows of a contiguous range of
    checks (``check_ranges``). Per iteration: the rank runs the check pass
    on its rows; the ranks ``all_gather`` the check->bit messages; each
    rank forms every bit's total in the unsharded decoder's order
    (``_sum_terms``, llr first) and keeps the new bit->check messages of
    its own rows. Only data movement is added, so decisions and iterations
    equal the unsharded decoder's bit for bit. Every rank calls ``decode``
    with the same inputs and gets the same ``DecodeResult``."""
    ranges = check_ranges(layout, mesh.world_size)
    spans = [check_row_edges(layout, lo, hi) for lo, hi in ranges]

    def gather(own: torch.Tensor) -> torch.Tensor:
        if mesh.world_size == 1:
            return own
        rows = max(e1 - e0 for e0, e1 in spans)
        padded = own.new_zeros((rows, own.shape[1]))
        padded[:own.shape[0]] = own
        parts = [torch.empty_like(padded) for _ in spans]
        dist.all_gather(parts, padded, group=mesh.group)
        return torch.cat([p[:e1 - e0] for p, (e0, e1) in zip(parts, spans)])

    return make_decoder(layout, algorithm, max_iterations, False, dtype,
                        rows=ranges[mesh.rank], gather=gather)
