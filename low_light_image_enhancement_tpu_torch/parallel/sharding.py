"""Meshes of devices and sharded execution: one process drives a grid of
``torch.device``s.

A :class:`Mesh` has a ``data`` axis (batch parallelism) and a ``spatial``
axis (image rows, for frames too large or too latency-sensitive for one
device: BASELINE config 5). Each shard's work is launched on its own device
from the one host thread; CUDA launches return before the work is done, so
the work of distinct cards overlaps. Halos move between shards as copies
(``parallel.halo``), and results are gathered onto the mesh's first device.

A mesh may hold a device more than once: ``[cpu] * 8`` is the CPU tests'
counterpart of the JAX package's eight fake devices, and ``[cuda:0] * 8``
runs eight shards on one card, which holds a sharded result to the
single-device one. Shards on one device run one after another.

Inside a process group (``parallel.distributed``), a mesh's ``spatial``
axis may span the processes: each process holds the same number of
consecutive shards on its own devices, process p the p-th run of them, and
``enhance_spatial_sharded`` then takes and returns each process's own
rows, the halos at the seams between processes crossing the group
(``parallel.halo.exchange_seams``).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import pad_edge
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    fused_retinex_canvas,
)
from low_light_image_enhancement_tpu_torch.parallel.halo import (
    exchange_seams,
    halo_pad,
)

__all__ = ["Mesh", "make_mesh", "local_devices", "mesh_for", "replicate",
           "replicas", "shard_batch_fn", "enhance_spatial_sharded"]


class Mesh:
    """An ``n_data x n_spatial`` grid of devices: ``devices[d][s]`` holds
    the s-th row block of the d-th batch chunk. A mesh whose spatial axis
    spans ``processes`` processes holds this process's columns of the grid
    (shards ``process_index * k`` to ``process_index * k + k - 1``, k =
    ``len(devices[0])``); ``shape`` is the whole grid's."""

    axis_names = ("data", "spatial")

    def __init__(self, devices: Sequence[Sequence[Any]], processes: int = 1,
                 process_index: int = 0):
        grid = [[torch.device(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(r) != len(grid[0])
                                          for r in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        types = {d.type for row in grid for d in row}
        if len(types) != 1:
            raise ValueError(f"a mesh holds devices of one type, got "
                             f"{sorted(types)}")
        if not 0 <= process_index < processes:
            raise ValueError(f"process {process_index} of {processes}")
        self.devices = grid
        self.processes, self.process_index = processes, process_index

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices),
                "spatial": len(self.devices[0]) * self.processes}

    def require_local(self, who: str) -> None:
        """Raise unless the mesh lies within this process."""
        if self.processes > 1:
            raise ValueError(f"{who} runs on a mesh within one process; "
                             f"this one spans {self.processes} processes "
                             "(only enhance_spatial_sharded takes that)")

    @property
    def flat(self) -> List[torch.device]:
        """The devices in row-major order: the order in which a batch
        sharded over both axes is split."""
        return [d for row in self.devices for d in row]

    @property
    def home(self) -> torch.device:
        """The first device, where results are gathered."""
        return self.devices[0][0]

    def distinct(self) -> List[torch.device]:
        """Each device once, in mesh order."""
        return list(dict.fromkeys(self.flat))

    def __repr__(self) -> str:
        span = (f", process {self.process_index} of {self.processes}"
                if self.processes > 1 else "")
        return f"Mesh({self.shape}, {self.devices}{span})"


def local_devices() -> List[torch.device]:
    """The CUDA devices this process drives: every card, or, inside a
    process group of more than one process, the one card it was given
    (``parallel.distributed.initialize_distributed``)."""
    import torch.distributed as dist

    if not torch.cuda.is_available():
        return []
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return [torch.device("cuda", torch.cuda.current_device())]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_data: Optional[int] = None, n_spatial: int = 1,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """A ("data", "spatial") mesh over ``devices`` (default: this
    process's CUDA devices, :func:`local_devices`). ``n_data`` defaults to
    the devices left over by ``n_spatial``.

    Inside a process group of P > 1 processes, an ``n_data x n_spatial``
    that is P times this process's devices spans the processes: its
    spatial axis is split into P runs of ``n_spatial / P`` shards, process
    p holding the p-th on its devices (``n_data * n_spatial / P`` of them),
    as the JAX package's mesh over every process's devices is."""
    devices = [torch.device(d) for d in devices] if devices is not None \
        else local_devices()
    if n_data is None:
        if len(devices) % n_spatial:
            raise ValueError(
                f"{len(devices)} devices not divisible by "
                f"n_spatial={n_spatial}")
        n_data = len(devices) // n_spatial
    need = n_data * n_spatial
    if need < 1:
        raise ValueError(f"a mesh needs at least one device: {n_data} x "
                         f"{n_spatial}")
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        process_group_size,
    )

    procs = process_group_size()
    if need > len(devices) and procs > 1 and n_spatial % procs == 0 \
            and need == procs * len(devices):
        import torch.distributed as dist

        k = n_spatial // procs
        return Mesh([devices[d * k:(d + 1) * k] for d in range(n_data)],
                    processes=procs, process_index=dist.get_rank())
    if need > len(devices):
        across = (f": a mesh holds this process's devices or, for halos "
                  f"across processes, the {procs} processes' ({procs} x "
                  f"{len(devices)}, n_spatial a multiple of {procs})"
                  if procs > 1 else "")
        raise ValueError(f"need {need} devices, have {len(devices)}{across}")
    return Mesh([devices[d * n_spatial:(d + 1) * n_spatial]
                 for d in range(n_data)])


def mesh_for(device, n_data: int, n_spatial: int) -> Mesh:
    """The mesh a pipeline on ``device`` runs a config's ``n_data x
    n_spatial`` on: on CUDA this process's cards, each count clamped to
    the cards there are (one card serves config 5 as one shard); on the
    CPU the CPU device repeated, unclamped."""
    device = torch.device(device)
    if device.type == "cuda":
        k = max(1, len(local_devices()))
        return make_mesh(min(n_data, k), min(n_spatial, k))
    return make_mesh(n_data, n_spatial, [device] * (n_data * n_spatial))


def replicate(tree, device):
    """``tree`` (a tensor, or dicts, lists and tuples of them; None stays
    None) with every tensor on ``device`` (tensors already there are not
    copied)."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, non_blocking=True)
    if isinstance(tree, dict):
        return {k: replicate(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(v, device) for v in tree)
    return tree


def replicas(tree, mesh: Mesh) -> Dict[torch.device, Any]:
    """One copy of ``tree`` on each distinct device of the mesh."""
    return {dev: replicate(tree, dev) for dev in mesh.distinct()}


def shard_batch_fn(fn: Callable, mesh: Mesh) -> Callable:
    """Data-parallel wrapper: ``wrapped(batch, *rest)`` splits ``batch``'s
    leading (batch) dim over every mesh device in order, runs ``fn(chunk,
    *rest)`` on each chunk's device (``rest`` copied there once a device),
    and returns the chunks' results joined on the mesh's first device."""
    mesh.require_local("shard_batch_fn")
    devs = mesh.flat

    @functools.wraps(fn)
    def wrapped(batch, *rest):
        batch = torch.as_tensor(batch)
        n = len(devs)
        if batch.shape[0] % n:
            raise ValueError(f"batch {batch.shape[0]} not divisible by the "
                             f"mesh's {n} devices")
        k = batch.shape[0] // n
        reps = replicas(rest, mesh)
        outs = [fn(batch[i * k:(i + 1) * k].to(dev, non_blocking=True),
                   *reps[dev])
                for i, dev in enumerate(devs)]
        return torch.cat([o.to(mesh.home, non_blocking=True) for o in outs])

    return wrapped


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _process_rows(x: torch.Tensor, mesh: Mesh) -> List[int]:
    """The rows each process of a mesh that spans processes holds, after
    checking that all hold the same batch, channels, width and dtype."""
    import torch.distributed as dist

    b, c, rows, w = x.shape
    mine = torch.tensor([b, c, rows, w, int(x.dtype == torch.float32)],
                        dtype=torch.int64, device=_comm_device(mesh))
    got = [torch.empty_like(mine) for _ in range(mesh.processes)]
    dist.all_gather(got, mine)
    got = [t.tolist() for t in got]
    if any(g[:2] + g[3:] != got[0][:2] + got[0][3:] for g in got):
        raise ValueError(f"the processes' rows differ in batch, channels, "
                         f"width or dtype: {got}")
    return [g[2] for g in got]


def _check_split(rows: List[int], mesh: Mesh, hl: int) -> None:
    """Each process must hold the rows its shards own: all but the last
    ``k * hl``, the last the rest (at least one)."""
    own = len(mesh.devices[0]) * hl
    if rows[:-1] != [own] * (len(rows) - 1) or not 0 < rows[-1] <= own:
        raise ValueError(
            f"the processes hold {rows} rows of a {sum(rows)}-row image; "
            f"{mesh.shape['spatial']} shards of {hl} rows give {own} to "
            "each process but the last, which takes the rest")


def _comm_device(mesh: Mesh) -> torch.device:
    """Where the process group's tensors live: the card on NCCL, the host
    on gloo (which sends host tensors only)."""
    import torch.distributed as dist

    return mesh.home if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def _sharded_rows(x: torch.Tensor, mesh: Mesh, hl: int, wp: int, m: int,
                  halo: int, run: Callable) -> torch.Tensor:
    """The shared frame of the sharded routes: ``x`` edge-padded to this
    process's ``k * hl`` rows (``k`` its shards; the rows past the image's
    ``h`` replicate its last row) and ``wp`` columns (``m`` of them before
    the image), its batch split over ``data`` and its rows over the
    process's shards, each block halo-padded by ``halo`` rows on its device
    (at a seam between processes, with the rows the neighbour process
    sends), ``run(block, global shard index, device)`` -> that shard's
    ``hl`` output rows, gathered onto the mesh's first device and cropped
    to ``x``'s rows and the image's columns."""
    n_d = mesh.shape["data"]
    k = len(mesh.devices[0])
    s0 = mesh.process_index * k
    b, _, rows, w = x.shape
    if b % n_d:
        raise ValueError(f"batch {b} not divisible by the mesh's data axis "
                         f"({n_d})")
    bs = b // n_d
    if mesh.processes > 1 and hl < halo:
        raise ValueError(
            f"shards of {hl} rows hold fewer rows than the {halo}-row halo; "
            "use fewer shards or larger frames")
    xc = pad_edge(x, 0, k * hl - rows, m, wp - w - m).contiguous()
    chunks = []
    for d, row in enumerate(mesh.devices):
        part = xc[d * bs:(d + 1) * bs]
        above = below = None
        if mesh.processes > 1:
            above, below = exchange_seams(
                part, halo, mesh.process_index, mesh.processes,
                _comm_device(mesh))
        blocks = halo_pad([part[..., s * hl:(s + 1) * hl, :].to(
            dev, non_blocking=True) for s, dev in enumerate(row)], halo,
            above=above, below=below)
        outs = [run(xb, s0 + s, dev) for s, (xb, dev) in
                enumerate(zip(blocks, row))]
        chunks.append(torch.cat(
            [o.to(mesh.home, non_blocking=True) for o in outs], dim=-2))
    return torch.cat(chunks)[..., :rows, m:m + w]


def enhance_spatial_sharded(
    x: torch.Tensor,
    cfg: PipelineConfig,
    mesh: Mesh,
    model_params: Optional[Dict[str, Any]] = None,
) -> torch.Tensor:
    """Spatially sharded enhance (config 5: per-shard denoise), any method.

    Args:
      x: (B, 3, H, W) planar batch, uint8, or float32 in [0, 1]. On a mesh
        that spans processes, this process's rows of the image: the rows
        its shards own (rows a shard rounded to 8 over the whole mesh, as
        for one process), the last process the rest.
      mesh: rows shard over its ``spatial`` axis, the batch over ``data``
        (the batch must divide by it).
      model_params: the learned methods' weights (unused by retinex).

    The output is the single-device output, as the JAX package's: each
    shard's block holds exactly the rows the single-device canvas holds.
    retinex runs K1's canvas form (u8 or f32) on each shard's ``(B, 3, hl +
    2m, wp)`` block; the learned methods
    run ``blocks.enhance_learned_block`` with the net's receptive field as
    the halo (``blocks.learned_halo``), the same block function the
    pipeline runs.

    Returns (B, 3, H, W) of the input's dtype (on a mesh that spans
    processes, this process's rows) on the mesh's first device.
    """
    if x.ndim != 4 or x.shape[1] != 3:
        raise ValueError(f"expected a planar (B, 3, H, W) batch, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"expected uint8 or float32, got {x.dtype}")
    if cfg.method != "retinex" and model_params is None:
        raise ValueError(
            f"method={cfg.method!r} needs model_params (e.g. "
            "EnhancePipeline._default_params(cfg, seed) or trained "
            "weights); only 'retinex' runs weight-free")
    n_sp = mesh.shape["spatial"]
    w = x.shape[-1]
    m = canvas_margin(cfg)
    if cfg.method == "retinex":
        halo = m
        geometry = lambda h: (_round_up(math.ceil(h / n_sp), 8),
                              _round_up(w + 2 * m, 128))
    else:
        from low_light_image_enhancement_tpu_torch.blocks import (
            block_geometry,
            learned_halo,
        )

        halo = learned_halo(cfg)
        geometry = lambda h: block_geometry(cfg, h, w, n_shards=n_sp)
    rows = _process_rows(x, mesh) if mesh.processes > 1 else [x.shape[-2]]
    h = sum(rows)
    hl, wp = geometry(h)
    if mesh.processes > 1:
        _check_split(rows, mesh, hl)
    if cfg.method == "retinex":
        run = lambda canvas, s, dev: fused_retinex_canvas(canvas, cfg, m, hl)
    else:
        from low_light_image_enhancement_tpu_torch.blocks import (
            enhance_learned_block,
        )

        params = replicas(model_params, mesh)

        def run(xb, s, dev):
            return enhance_learned_block(xb, cfg, params[dev], s * hl - halo,
                                         h, w, halo=halo)

    return _sharded_rows(x, mesh, hl, wp, m, halo, run)
