"""Carry scene and camera state across from the JAX package as numpy.

The JAX package's FlatScene and CameraState are pytrees of device arrays;
this package cannot import JAX, so state crosses the boundary as plain numpy
arrays plus the static metadata. The tests use these to feed both packages
identical tables, and to check this package's compile_scene against the
JAX one table by table:

    arrays, meta = flat_to_numpy(jax_flat)      # or this package's FlatScene
    flat = flat_from_numpy(arrays, meta, device="cpu")
    cam = camera_from_numpy(camera_to_numpy(jax_cam), device="cpu")
    params = params_from_numpy(
        {k: np.asarray(v) for k, v in jax_train.get_params(jax_flat).items()},
        device="cpu")
    prog = progressive_from_numpy(                # a JAX progressive run
        scene, {"acc": np.asarray(jax_prog.acc),
                "samples_taken": jax_prog.samples_taken,
                "seed": jax_prog.seed, "n_strata": jax_prog.n_strata},
        device="cpu")                             # continued in the port
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .flat import FlatScene, STATIC_FIELDS
from ..models.camera import CameraState


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def flat_from_numpy(arrays: dict, meta: dict, device) -> FlatScene:
    """FlatScene from numpy tables (one per tensor field, same names and
    dtypes as the JAX FlatScene) and the static metadata dict."""
    names = [f.name for f in dataclasses.fields(FlatScene)
             if f.name not in STATIC_FIELDS]
    missing = [n for n in names if n not in arrays and
               FlatScene.__dataclass_fields__[n].default is dataclasses.MISSING]
    if missing:
        raise KeyError(f"flat_from_numpy: missing tables {missing}")
    tensors = {n: _tensor(arrays[n], device) for n in names
               if arrays.get(n) is not None}
    statics = {n: meta[n] for n in STATIC_FIELDS if n in meta}
    if "tex_struct" in statics:
        statics["tex_struct"] = tuple(tuple(int(x) for x in row)
                                      for row in statics["tex_struct"])
    return FlatScene(**tensors, **statics)


def _numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def flat_to_numpy(flat) -> tuple[dict, dict]:
    """The inverse of flat_from_numpy: (arrays, meta) of a FlatScene of
    this package or of the JAX package (whose arrays np.asarray converts)."""
    arrays = {f.name: _numpy(getattr(flat, f.name))
              for f in dataclasses.fields(flat)
              if f.name not in STATIC_FIELDS
              and getattr(flat, f.name) is not None}
    meta = {n: getattr(flat, n) for n in STATIC_FIELDS}
    return arrays, meta


def camera_to_numpy(cam) -> dict:
    """The vectors of a CameraState of either package, as numpy."""
    return {f.name: _numpy(getattr(cam, f.name))
            for f in dataclasses.fields(CameraState)}


def camera_from_numpy(arrays: dict, device) -> CameraState:
    """CameraState from numpy vectors named as the JAX CameraState's."""
    names = [f.name for f in dataclasses.fields(CameraState)]
    return CameraState(**{n: _tensor(np.asarray(arrays[n], np.float32),
                                     device) for n in names})


def params_from_numpy(params: dict, device) -> dict:
    """The JAX package's trainable params (its parallel/train.get_params,
    each array as numpy) as this package's tensors on `device`: the same
    names, shapes and dtypes, so both packages train from one state."""
    return {k: _tensor(np.asarray(v), device) for k, v in params.items()}


def progressive_from_numpy(scene, state: dict, *, device="cuda",
                           use_bvh: bool = False, engine: str = "auto"):
    """A ProgressiveRenderer of `scene` that continues the JAX package's
    progressive state, given as numpy: `acc` (H, W, 3) float32, the
    radiance sum of `samples_taken` strata drawn under `seed`, at
    `n_strata` strata an axis, at the scene's own camera. Raises
    ValueError when n_strata or the image shape is not the scene's."""
    from ..models.render import ProgressiveRenderer
    prog = ProgressiveRenderer(scene, device=device, use_bvh=use_bvh,
                               seed=int(state["seed"]), engine=engine)
    if int(state["n_strata"]) != prog.n_strata:
        raise ValueError(f"n_strata is {int(state['n_strata'])}, the "
                         f"scene's is {prog.n_strata}")
    prog.restore(np.asarray(state["acc"]),
                 int(state["samples_taken"]), int(state["seed"]))
    return prog
