"""Checkpoint / resume for progressive renders (port of
gpu_ray_tracing_tpu/utils/checkpoint.py).

The resumable state is an AccumState (running mean + sample count), saved
as a plain .npz with the JAX package's keys (`version`, `rgb`, `count`,
optionally `fingerprint`), so a checkpoint JAX wrote loads here and one
written here loads there.  A save replaces the target atomically.  The
fingerprint hashes the port's own tensors: it guards a resume within the
port and need not equal the JAX package's digest; a checkpoint without one
loads unchecked.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from gpu_ray_tracing_tpu_torch.models.scene import as_scene
from gpu_ray_tracing_tpu_torch.ops import rng as rng_ops
from gpu_ray_tracing_tpu_torch.ops.accumulate import AccumState
from gpu_ray_tracing_tpu_torch.ops.cuda.megakernel import dataclass_tensors

_FORMAT_VERSION = 1


def render_fingerprint(scene, config, *, frame_seed=None, key=None) -> str:
    """Stable hash of everything that determines a render's sample stream:
    the sample-relevant config fields, every array of the scene, the frame
    seed and the threefry key's two u32 words (ops/rng.as_key), hashed as
    the JAX package hashes them.  Scheduler-only choices (backend, adaptive knobs) are left
    out, so a checkpoint written by one backend resumes on the other.  The
    spp budget enters only through the stratified sampler, whose grid it
    sets; the other samplers address samples by absolute index, so a
    finished render can be extended to a larger budget."""
    if config.sampler == "stratified":
        sampler_id: tuple = config.sampler_spec
    else:
        sampler_id = (config.sampler,)
    h = hashlib.sha256()
    h.update(repr((
        "v2",
        config.width, config.height, config.max_depth,
        config.integrator, config.rng, sampler_id, config.parity,
        config.nee, config.mis, config.clamp, config.sky_intensity,
        config.russian_roulette_depth, config.t_min, config.t_max,
    )).encode())
    if frame_seed is not None:
        h.update(b"seed" + np.asarray(int(frame_seed) & 0xFFFFFFFF, np.uint32).tobytes())
    if key is not None:
        h.update(b"key" + np.asarray(rng_ops.as_key(key), np.uint32).tobytes())
    for leaf in dataclass_tensors(as_scene(scene)):
        a = leaf.detach().cpu().numpy()
        h.update(f"{a.shape}{a.dtype}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def checkpoint_path(path: str) -> str:
    """The on-disk filename for `path`: np.savez appends '.npz' to bare
    paths, so save, load and exists all normalize the same way."""
    return path if path.endswith(".npz") else path + ".npz"


def save_accum(path: str, state: AccumState, fingerprint: str | None = None) -> None:
    """Serialize an accumulation state to .npz, atomically: a sibling temp
    file is os.replace()d over the target, so an interrupted save keeps the
    previous checkpoint.  `fingerprint` (render_fingerprint) stamps it."""
    path = checkpoint_path(path)
    tmp = path + ".tmp.npz"  # .npz suffix so np.savez doesn't append one
    extra = {} if fingerprint is None else {"fingerprint": np.str_(fingerprint)}
    np.savez(
        tmp,
        version=np.int32(_FORMAT_VERSION),
        rgb=state.rgb.detach().cpu().numpy().astype(np.float32),
        count=np.int32(int(state.count)),
        **extra,
    )
    os.replace(tmp, path)


def load_accum(path: str, expect_fingerprint: str | None = None,
               device=None) -> AccumState:
    """Restore an accumulation state saved by save_accum (by either
    package), its image on `device`.  A checkpoint stamped with another
    fingerprint than `expect_fingerprint` is refused; one with no stamp
    loads unchecked."""
    with np.load(checkpoint_path(path)) as data:
        if "version" not in data or "rgb" not in data or "count" not in data:
            raise ValueError(
                f"{checkpoint_path(path)} is not a save_accum checkpoint "
                f"(keys: {sorted(data.files)})"
            )
        version = int(data["version"])
        if version != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {version}")
        if expect_fingerprint is not None and "fingerprint" in data:
            found = str(data["fingerprint"])
            if found != expect_fingerprint:
                raise ValueError(
                    f"{checkpoint_path(path)} was written for a different "
                    "render (scene/seed/config fingerprint "
                    f"{found[:12]}… != expected {expect_fingerprint[:12]}…); "
                    "resuming would fold mismatched samples — delete the "
                    "checkpoint or restore the original flags"
                )
        rgb = np.asarray(data["rgb"], np.float32)
        if rgb.ndim != 3 or rgb.shape[-1] != 3:
            raise ValueError(f"checkpoint rgb has shape {rgb.shape}; expected (H, W, 3)")
        return AccumState(
            rgb=torch.from_numpy(rgb.copy()).to(device),
            count=torch.tensor(int(data["count"]), dtype=torch.int32),
        )
