"""Tile x sample rendering over a mesh of processes (torch.distributed).

Port of the JAX package's parallel/mesh.py (34-149). The reference's only
parallel layer is a work-stealing thread pool over pixel rows
(ThreadPool.hpp); the JAX package spreads the same data-parallel structure
over a 2D device mesh, and so does the port, over ranks:

  axis "tile"   — pixel row blocks of the image (a rank renders its rows:
                  the kernels' row0 offset, csrc/wavefront.cu WfParams)
  axis "sample" — stratified sample batches (a rank renders a range of
                  the samples: the passes' sample_start)

PyTorch's idiom is one process a GPU, so the mesh covers the ranks of the
process world (torch.distributed, parallel/distributed.py::initialize),
not the devices of one process: a `RenderMesh` names this rank's place in
an (n_tile, n_sample) grid of ranks, rank = tile * n_sample + sample, with
a torch DeviceMesh of dims ("tile", "sample") for its groups. A world of
one process is the 1 x 1 mesh and needs no process group.

Every rank holds the whole scene. The one collective of a render is an
all_reduce (sum) over "sample" (the JAX psum), which merges the sample
batches of a tile; render_on_mesh then gathers the tiles over "tile" so
that every rank holds the image. The draws are keyed on the absolute
(pixel, sample), so the image does not depend on the mesh layout: a
tile-only layout gives the one-process image of the same passes bit for
bit (a pixel's samples are summed by one thread, in order), and a sample
split sums the same samples in another order.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..scene.flat import FlatScene
from ..scene.schema import CameraConfig, Scene
from ..scene.compile import compile_scene
from ..models import camera as cam_mod
from ..models.render import (_pass_sum, default_tile_rows, pick_engine,
                             resolve_device)
from ..ops.wavefront_cuda import pass_function

AXES = ("tile", "sample")


@dataclass(frozen=True)
class RenderMesh:
    """This rank's place in an (n_tile, n_sample) grid of ranks: its tile
    and sample coordinates and the torch DeviceMesh whose groups carry the
    collectives. device_mesh None means no collective runs: the 1 x 1 mesh
    of a one-process world, or one shard of a layout rendered in this
    process (local_shard)."""
    n_tile: int = 1
    n_sample: int = 1
    tile: int = 0
    sample: int = 0
    device_mesh: object = None

    @property
    def shape(self) -> dict:
        return {"tile": self.n_tile, "sample": self.n_sample}

    @property
    def size(self) -> int:
        return self.n_tile * self.n_sample

    def group(self, axis: str):
        """The process group of this rank's `axis` ("tile" or "sample"),
        or None where no collective runs (no device_mesh). A mesh over a
        process group runs its collectives on every axis, one of one rank
        too."""
        if axis not in AXES:
            raise ValueError(f"axis must be one of {AXES}, got {axis!r}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def world_group(self):
        """The group of every rank of the mesh, or None (no collective)."""
        return None if self.device_mesh is None else dist.group.WORLD

    def shard(self, height: int, total_spp: int) -> tuple:
        """(row0, h_local, sample0, spp_local) of this rank for an image
        `height` rows tall and total_spp samples a pixel; raises unless
        n_tile divides the height and n_sample the samples (the JAX
        render_sharded asserts the same, 92-93)."""
        if height % self.n_tile:
            raise ValueError(f"height {height} is not a multiple of the "
                             f"tile axis ({self.n_tile}); render_on_mesh "
                             "pads it")
        if total_spp % self.n_sample:
            raise ValueError(f"{total_spp} samples a pixel are not a "
                             f"multiple of the sample axis "
                             f"({self.n_sample}); render_on_mesh raises "
                             "n_strata until they are")
        h_local = height // self.n_tile
        spp_local = total_spp // self.n_sample
        return (self.tile * h_local, h_local, self.sample * spp_local,
                spp_local)


def _layout(n: int, n_tile: int | None, n_sample: int | None) -> tuple:
    """The JAX make_render_mesh layout of n ranks (40-48): n_sample 2 on an
    even count above 1, n_tile the rest."""
    if n_tile is None and n_sample is None:
        n_sample = 2 if n % 2 == 0 and n > 1 else 1
        n_tile = n // n_sample
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    if n_tile < 1 or n_sample < 1 or n_tile * n_sample != n:
        raise ValueError(f"a {n_tile} x {n_sample} mesh does not cover "
                         f"{n} rank(s)")
    return n_tile, n_sample


def make_render_mesh(n_tile: int | None = None,
                     n_sample: int | None = None) -> RenderMesh:
    """A ("tile", "sample") mesh over the ranks of the process world
    (torch.distributed's default group). One process without a group is
    the 1 x 1 mesh, with no collectives. The default layout is the JAX
    package's: n_sample 2 on an even rank count above 1. Every rank of the
    world calls this with the same arguments (it creates the axes'
    groups)."""
    if not dist.is_initialized():
        _layout(1, n_tile, n_sample)
        return RenderMesh()
    n_tile, n_sample = _layout(dist.get_world_size(), n_tile, n_sample)
    from torch.distributed.device_mesh import init_device_mesh
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    dm = init_device_mesh(device_type, (n_tile, n_sample),
                          mesh_dim_names=AXES)
    return RenderMesh(n_tile, n_sample, dm.get_local_rank("tile"),
                      dm.get_local_rank("sample"), dm)


def local_shard(n_tile: int, n_sample: int, tile: int,
                sample: int) -> RenderMesh:
    """Shard (tile, sample) of an n_tile x n_sample layout, rendered in
    this process with no collective: render_sharded and the mesh training
    render (parallel/train.py) return this shard's part, the sum over its
    samples divided by the image's total, for its rows. Summed over the
    sample shards of each tile, the parts give the mesh's image; how a
    check holds the kernels' shards against one pass in one process."""
    if not (0 <= tile < n_tile and 0 <= sample < n_sample):
        raise ValueError(f"shard ({tile}, {sample}) outside a {n_tile} x "
                         f"{n_sample} mesh")
    return RenderMesh(n_tile, n_sample, tile, sample)


# ---------------------------------------------------------------- collectives
def _host_staged(x: torch.Tensor, group) -> bool:
    """Whether a collective on x goes through host memory: gloo's, on a
    CUDA tensor (ranks that share a GPU, parallel/distributed.py)."""
    return x.is_cuda and dist.get_backend(group) != "nccl"


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A new tensor: x summed over the ranks of `group` (x itself for
    group None). No autograd: the caller says what the backward is."""
    if group is None:
        return x
    staged = _host_staged(x, group)
    # a contiguous copy: the passes' images are dense transposed views of
    # their lane planes, and the collectives take contiguous tensors only
    y = x.detach().to("cpu" if staged else x.device, copy=True,
                      memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y.to(x.device) if staged else y


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The tensors x of the ranks of `group`, concatenated along dim 0 in
    rank order (x itself for group None)."""
    if group is None:
        return x
    staged = _host_staged(x, group)
    y = x.detach().to("cpu" if staged else x.device).contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts).to(x.device)


# ------------------------------------------------------------------ render
def render_shard(flat: FlatScene, cam: cam_mod.CameraState, seed, *,
                 width: int, h_local: int, row0: int, n_strata: int,
                 spp_local: int, sample0: int, max_depth: int,
                 sky_gradient: bool, engine: str = "auto",
                 schedule: str = "auto", caps=None,
                 run_pass=None) -> torch.Tensor:
    """The (h_local, width, 3) radiance sum of rows [row0, row0 + h_local)
    and samples [sample0, sample0 + spp_local) of the image: the JAX
    _tile_sample_render (51-73). One pass of render's pass body
    (models/render.py::_pass_sum) under render's rules: the engine by
    pick_engine (the kernels on a CUDA device, the plain integrator on the
    CPU), and on the kernels the compacted schedule from 8 samples
    (schedule "auto"), else one pass. run_pass is the packed kernel pass
    (pass_function), packed here when not given."""
    eng = pick_engine(flat, engine)
    if eng == "cuda" and run_pass is None:
        run_pass = pass_function(flat, cam)
    tr = default_tile_rows(width, h_local, flat.n_prims)
    return _pass_sum(eng, flat, cam, run_pass, seed, sample0, spp_local,
                     schedule=schedule, caps=caps, tile_rows=tr, width=width,
                     height=h_local, n_strata=n_strata, max_depth=max_depth,
                     sky_gradient=sky_gradient, row0=row0)


def render_sharded(flat: FlatScene, cam: cam_mod.CameraState, seed, *,
                   mesh: RenderMesh, width: int, height: int, n_strata: int,
                   max_depth: int, sky_gradient: bool, engine: str = "auto",
                   schedule: str = "auto", caps=None) -> torch.Tensor:
    """This rank's rows of the averaged image, (height / n_tile, width, 3):
    its shard's radiance sum (render_shard), summed over the "sample" axis
    (all_reduce) and divided by the image's n_strata^2 samples (JAX
    render_sharded, 78-122). height must be a multiple of n_tile and
    n_strata^2 of n_sample (render_on_mesh pads both)."""
    total = n_strata * n_strata
    row0, h_local, sample0, spp_local = mesh.shard(height, total)
    acc = render_shard(flat, cam, seed, width=width, h_local=h_local,
                       row0=row0, n_strata=n_strata, spp_local=spp_local,
                       sample0=sample0, max_depth=max_depth,
                       sky_gradient=sky_gradient, engine=engine,
                       schedule=schedule, caps=caps)
    return all_reduce_sum(acc, mesh.group("sample")) / total


def mesh_strata(n_strata: int, n_sample: int) -> int:
    """n_strata raised until n_sample divides n_strata^2 (the JAX
    render_on_mesh's padding of the sample count, 143-145)."""
    while (n_strata * n_strata) % n_sample:
        n_strata += 1
    return n_strata


def render_on_mesh(scene: Scene | FlatScene, cfg: CameraConfig | None = None,
                   *, mesh: RenderMesh | None = None, seed: int = 0,
                   use_bvh: bool = False, engine: str = "auto",
                   device="cuda", schedule: str = "auto",
                   caps=None) -> torch.Tensor:
    """The whole (H, W, 3) averaged image on every rank of `mesh` (default
    make_render_mesh()): compile the scene (a Scene, on `device`; a
    FlatScene is taken as it is, with its CameraConfig), pad the height to
    a multiple of the tile axis, raise n_strata until the sample axis
    divides its square, render this rank's shard (render_sharded), gather
    the tiles over "tile" and crop the padding (JAX 125-149)."""
    if isinstance(scene, Scene):
        cfg = cfg or scene.camera
        flat = compile_scene(scene, use_bvh=use_bvh,
                             device=resolve_device(device))
    else:
        if cfg is None:
            raise ValueError("a FlatScene needs an explicit CameraConfig")
        flat = scene
    mesh = mesh or make_render_mesh()
    if mesh.n_tile > 1 and mesh.device_mesh is None:
        raise ValueError("a local shard has no tile group to gather the "
                         "image over: use render_sharded")
    width, height = cam_mod.image_size(cfg)
    hp = -(-height // mesh.n_tile) * mesh.n_tile
    n_strata = mesh_strata(cam_mod.sqrt_spp(cfg), mesh.n_sample)
    img = render_sharded(flat, cam_mod.derive(cfg, device=flat.device), seed,
                         mesh=mesh, width=width, height=hp,
                         n_strata=n_strata, max_depth=cfg.max_depth,
                         sky_gradient=cfg.sky_gradient, engine=engine,
                         schedule=schedule, caps=caps)
    return all_gather_rows(img, mesh.group("tile"))[:height]
