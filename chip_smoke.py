#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (gpu_ray_tracing_tpu_torch).

Run from the root of a checkout, on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds gpu_ray_tracing_tpu_torch/ops/cuda/megakernel.cu (the render kernels
of both engines), wavefront.cu (the wavefront engine's device loop) and
probes.cu with nvcc, side by side, then drives the port's main paths on the
card in phases, one JSON line each:

  1. device       the card, its compute capability and power limit
  2. build        nvcc version, build seconds, each kernel instance's registers,
                  stack and spills, render_kernel's and render_adaptive_kernel's
                  beside the kernels they replaced, and a digest of each
                  instance's SASS (cuobjdump) to compare two checkouts' builds
  3. hash_probe   the kernel's hashes vs ops/rng.py on 1M u32 values: bit-exact;
     sampler_probe  the kernel's stratified (4,4) and Sobol (nbits 5) remaps at
                  pair ids 5-8 on 1M (pixel id, sample) pairs: bit-exact; each
                  kernel timed alone behind the spin kernel on inputs packed
                  once (probe_launches), the wrapper's call beside it
  4. goldens      backend='cuda' renders vs the committed goldens (mesh_ico,
                  nee_light, nee_mis, many_mis and sobol_base included), at
                  tests/test_goldens.py's decision-flip thresholds; cornell_48x48
                  vs the plain version on the card at parity_check's 1.5% / 1e-3
  5. kernel_vs_plain  One-Weekend 320x180, 4 spp, depth 30: render_cuda vs
                  its plain PyTorch version, flip <= 1% and mean |diff| < 2e-4
  6. main_path    render(one_weekend_scene(0), CameraSettings.default(),
                  1280x720, 16 spp, depth 30, backend='cuda'): 2 warm-up and
                  5 timed frames (CUDA events), launch counts, output checks,
                  the kernel alone with its bounce Mrays/s (the rays its
                  counters measure), and the same frame from the plain version
  7. sphere_bvh   the 487-sphere One-Weekend final scene (a sphere BVH),
                  320x180, 4 spp, depth 50: the walk vs the plain version's
                  scan of the same spheres, flip <= 2% and mean < 2e-3, and
                  vs the brute kernel on the same spheres (timed beside it),
                  flip <= 1% and mean < 2e-4; and 1,025 random diffuse
                  spheres, one over the sphere stage, on the brute route's
                  global scan vs their plain version, flip <= 1% and mean
                  < 2e-4
  8. mesh_vs_plain  a smooth icosphere(4) (5,120 faces) on a ground sphere,
                  320x240, 2 spp, depth 8: flip <= 1% and mean < 2e-4
  9. config3      BASELINE config 3 through render(): the 487-sphere scene,
                  1280x720, 1 spp, depth 50, timed as phase 6 and held to
                  the plain version's frame at flip <= 2% and mean < 2e-3
 10. config4      BASELINE config 4 through render(): a smooth icosphere(6)
                  (81,920 faces) behind its BVH, 640x480, 1 spp, depth 8,
                  held to the plain version at flip <= 1% and mean < 2e-4;
     config1      BASELINE config 1 through render(): base_scene, 800x600,
                  1 spp, the normal AOV (render_aov_kernel's staged brute
                  scan), timed as config 3 and held to the plain version at
                  1% / 2e-4

 11. nee_vs_plain  the NEE kernel vs its plain version at 1% / 2e-4: _nee_scene
                  (nee+mis, RR 3, sky 0, 320x240, 4 spp, depth 8), the 81-light
                  _many_lights_scene (320x240, 4 spp, depth 4, the plain
                  version's per-(sample, bounce) pick) and the CLI's night scene
                  (2 sphere lights, metal and glass; 320x180, 4 spp, depth 30)
 12. lit_path     `render --scene cornell --nee --mis --sky-intensity 0` at the
                  CLI's defaults through render(): 1280x720, 16 spp, depth 30,
                  2 warm-up and 5 timed frames, the kernel alone timed too, held
                  to the plain frame at 1.5% / 1e-3
 13. sampler_path One-Weekend with sampler='sobol' through render() at the main
                  path's size, timed, held to its plain frame at 1% / 2e-4; and
                  'stratified' at 320x180, 16 spp
 14. bvh_builds   which BVH builder ran (it must be the native one)
 15. adaptive_vs_plain  the adaptive kernel (K1f) vs its plain version, min 4,
                  budget 32, depth 8: One-Weekend 320x180 at tol 0.03 and the
                  Cornell box (nee+mis) 128x96 at tol 0.5, where its tiles
                  stop at different counts; spp maps per tile (<= 1 tile may
                  differ, and some tile must stop before the budget) and
                  images over equal-count tiles at 1% / 2e-4 (Cornell: flip
                  1.5%, its contract in phase 12)
 16. adaptive_resume  at the main path's size (budget 32, tol 0.03, min 8):
                  render() equals four adaptive_progressive_step(8) bit for
                  bit, a fifth changes nothing, and tol 1e6 / min 4 equals the
                  fixed spp=4 frame bit for bit (the prefix property)
 17. adaptive_path  that frame one-shot, timed, with its spp map's mean/min/max,
                  beside the fixed 32-spp frame in the same call, and held to
                  its plain version as phase 15 holds the small frames; then
                  (adaptive_clusters) it and phase 15's Cornell box, kernel
                  alone, with a tile on 1, 2, 4, 8 and 16 blocks
 18. progressive_path  16 progressive_step calls at the main path's size: ms a
                  step, the state vs render(spp=16) at atol 1e-5, 16 launches,
                  reset, and two steps of 8 at atol 2e-5
 19. ray_count    the kernel's counters vs the plain version's per pixel, the
                  analytic cases, and at the main path's size rays traced, the
                  kernel with the counter on and off, bounce Mrays/s

 20. wavefront_vs_plain  the wavefront bounce kernel (K2) vs its plain version
                  (wavefront_bounce_reference) on the One-Weekend 320x180 state
                  after ray generation, 6 bounces, each fed the kernel's previous
                  state: rays whose live flag differs <= 1%, the state planes and
                  the finished samples of agreeing rays within 2e-4 mean; again
                  on _nee_scene (nee+mis) and with per-ray (sample, bounce); then
                  the device loop's partition (wavefront.cu), refill
                  (wavefront_raygen_kernel) and step against their plain
                  versions on a real 320x180 state, every sort, with and
                  without regeneration: permutation, planes, ids and counts
                  exactly, refilled rays within 1e-5; then render_wavefront
                  vs render_wavefront_reference, 320x180, 4 spp, depth 30, at
                  1% / 2e-4
 21. wavefront_path  the main frame through render(backend='wavefront'),
                  regenerate off: timed as phase 6, bit-equal to phase 6's frame,
                  with its bounce launches, compactions, host reads of the device
                  (one a frame) and live rays per bounce; regenerate on: timed,
                  <= 3e-5 from the first, twice for the run-to-run difference,
                  host reads at most one every POLL_EVERY iterations plus one;
                  both split into device time by kernel (bounce, ray generation,
                  partition and each of its kernels, step, other) and idle time
                  (torch.profiler), and every partition call of a frame with its
                  slots, live rays, what it did and its device ms
                  (partition_calls); the launches counted against the schedule
                  the host must enqueue for the iterations the device counted;
                  the loop's kernels timed at the main shape and held there to
                  their plain versions (the 16 samples' 14.7 M-slot array and
                  the 921,600-slot pool, every sort: fill, partition, refill and
                  step), the partition alone at both shapes, split by kernel,
                  beside torch.sort(keys, stable=True) + index_select on the
                  same keys (the same permutation); the sort keys, compaction
                  thresholds and sample
                  batches, three runs each; and small frames on the other
                  routes, each bit-equal to render_cuda
 22. fma_peak     the FP32 probe (K3) vs its plain version at 32 rounds, then
                  timed on a card-filling grid: TFLOP/s per mix and chain count
                  and the share of the nominal 67
 23. bf16_probe   the f32 / packed-bf16 probe (K4) vs its plain version at 32
                  rounds, then microseconds per launch on the 32x128 tile and on
                  a card-filling grid, product and compare forms, each against
                  its least time (9 operations a round, 10 with the compare,
                  at the issue rate of the type) and against the old bound
                  (9 operations a round over the type's FMA peak)
 24. regen_schedule  render_kernel's per-warp path regeneration against
                  render(backend='wavefront', regenerate='off') bit for bit,
                  ray counts included, on small frames that stress its
                  schedule: 50x31 at 3 spp, spp 1, 5, 16 and 37, a row band
                  (y_offset 1, row_stride 2), NEE+MIS with Russian roulette,
                  Sobol, stratified, the sphere BVH and a mesh; each launched
                  twice, the two frames identical
 25. adaptive_schedule  render_adaptive_kernel (a thread block cluster per
                  tile, warps that regenerate paths) against an oracle that
                  does not depend on its schedule: every tile whose spp map
                  reads k equals render_cuda(spp=k) there bit for bit, ray
                  counts included, on ragged frames (50x31, 200x70), a row
                  band, NEE+MIS with Russian roulette, the Cornell box,
                  Sobol, stratified, the sphere BVH, icosphere(4) and the
                  normal AOV (64-row tiles); each launched twice and with a
                  tile on 1 and on 16 blocks, all identical; resume in chunks
                  of 1, 3 and 8 equal to one shot on three of them

 26. grad_vs_plain  gradients through the kernels (ops/autograd.KernelFrame:
                  the kernel forward, a replay of the plain integrator as the
                  backward): d sum(w * render) for every float tensor of the
                  scene and the CameraSettings through backend='cuda' and
                  'wavefront' (regenerate off and on) against autograd
                  through backend='torch' on the card, per leaf at rtol 1e-5
                  / atol 1e-7, on tests/test_gradients.py's tri-light
                  NEE+MIS scene (24x16, 2 spp, depth 3, sky 0) and
                  base_scene (16x12, 1 spp, depth 4); the forward equal to
                  the frame without gradients bit for bit, the kernel
                  launched by the forward and nothing by the backward
 27. inverse_path  examples/inverse_rendering.py's settings on the card
                  (base_scene, its camera, 96x72, 4 spp, depth 6): 20 Adam
                  steps (lr 0.05) on a scrambled albedo, ms a step split into
                  forward and backward, the loss and the albedo error falling,
                  peak memory; then d mean(image)/d albedo of One-Weekend at
                  1280x720, 1 spp, depth 30, its ms, replay blocks and peak
                  memory, within rtol 1e-3 of central differences of
                  render_reference at the three entries of largest gradient
 28. denoise_path  render_denoised at the main frame (16 spp, 4 iterations):
                  5 timed frames (a beauty and one guides launch each), the
                  beauty pass, the guides launch (render_guides: the albedo,
                  normal and depth planes of one closest hit a sample) and
                  each single-mode guide pass, all through render_aov_kernel
                  alone with their bounds; every single-mode plane equal to
                  the guides launch's bit for bit, each held to its plain
                  version at 1% / 2e-4; the filter (device ms and kernel
                  launches, torch.profiler) held to the filter on the CPU on
                  the same planes at rtol 1e-5 / atol 1e-7; the denoised
                  frame nearer a 256-spp render than the beauty pass is; one
                  backward() through it (the beauty and three single-mode
                  passes), finite and nonzero
 29. aov_scan     render_aov_kernel's staged brute scan through the guides
                  launch at 1280x720: sphere counts 0, 1, 255, 256, 257,
                  1000, 1024, 1025 and 2500 (around the block, the BVH
                  threshold and the 1024-sphere staging chunk), 2000 spheres
                  with every third inactive (equal bit for bit to the scene
                  of its active ones) and a ragged 1283x717 One-Weekend
                  frame: each launched twice (identical), each plane equal
                  to its single-mode launch bit for bit and to the plain
                  version at 1% / 2e-4 (no sphere: the sky everywhere)

 30. cli_path     the command line end to end: `python3 -m
                  gpu_ray_tracing_tpu_torch render` in a subprocess at its
                  defaults (the main path: One-Weekend, 1280x720, 16 spp, depth
                  30, --backend auto, --device cuda), its PNG byte-equal to
                  to_uint8(tonemap(render(...))) of the API at the same seed,
                  with the subprocess's wall seconds (the torch import and the
                  cached build included); the same command in this process
                  (render() and write_image timed inside that call, host
                  clock synchronised with the card, and its host seconds
                  outside render()); cli.main with --bench-frames 20 (61
                  brute launches: the written frame and three timed windows
                  of 20; FrameStats' ms a frame), beside the same seeds
                  through render() in this call: phase 6's host inputs with
                  and without time_frames' per-frame sum, the settings on
                  the card (a camera derived a frame) and the CLI's camera
                  derived once on the card; at 320x180 --denoise 4 (one
                  beauty and one guides launch), --regenerate on (the
                  wavefront keys) and
                  --adaptive-tol 0.03 (one +adaptive launch); `progressive
                  --steps 2 --checkpoint` twice bit-equal to --steps 4 once,
                  with a --preview-every file; `animate --frames 2` (2 files)
                  and `view --no-input --max-steps 3 --cols 80` (half-block
                  cells); the WGSL stream's pixel_seeds, make_bounce_seeds and
                  seed_from_f32 on 1M values on the card bit-equal to the
                  CPU's, and base_parity_48x32 through backend='torch' with the
                  scene on the card at the golden's 0.5% / 1e-4.  Each run
                  sets the launch counts to 0 just before it and reads them
                  just after

 31. sharded      parallel.sharding on the card through K1 and K2, rank
                  processes spawned on the one H100 (each imports this file
                  and the port, never jax, and loads the cached build), every
                  run against the unsharded frame of its backend: the 1x1 mesh
                  over nccl (world 1: NCCL's all_gather on the card) at the main
                  path, bit for bit; over gloo with CUDA tensors where ranks
                  share the card (nccl puts no two ranks on one card; with a
                  card a rank, over nccl), 2x1 contiguous and interleaved at the
                  main path through 'cuda' and 'wavefront' (regeneration off),
                  bit for bit; BASELINE config 5's frame (make_scene(One-Weekend),
                  1920x1080, depth 20, roulette 5, 'cuda'): 8 interleaved
                  progressive_step_sharded steps and accum_image against 8
                  unsharded progressive_steps bit for bit; row-sharded adaptive
                  at 1280x768 (two bands of 384 rows; budget 32, tol 0.03, min 8),
                  the image and each band's spp map bit for bit; and on 4 ranks
                  the 2x2 main path (rtol 1e-5 / atol 1e-6) and config 5 in 4
                  steps of 2 samples against render(spp=8) at atol 2e-5.  The
                  ms a frame or step are each rank's on one shared card, not
                  scaling; each run's launches are counted on every rank and
                  gated on the route's key.  A rank that fails fails the phase
 32. threefry     render(rng='threefry', backend='torch') on the card,
                  One-Weekend 320x180, depth 8, 256 spp, timed: jax.random's
                  bits drawn on the card equal to the CPU's for one key; the
                  same key twice bit-equal, another key another frame; its
                  per-sample frames
                  (their mean in order is the frame, bit for bit) against the
                  hash stream's (render_cuda, a sample each): per pixel and
                  channel |mean difference| <= 4 standard errors for >= 99%,
                  and the frame means within 4 standard errors
 33. wf_stage     the wavefront bounce kernel's sphere stage (a block stages
                  the brute route's spheres in shared memory once a launch
                  and skips the roots of missed spheres) through
                  render(backend='wavefront') at 1280x720, regeneration off
                  and on, bit for bit against render(backend='cuda'), ray
                  counts included: sphere counts 0, 1, 255, 256, 257, 1024
                  and 1025 (the last takes the global scan), 1,000 spheres
                  with every third inactive against the scene of its active
                  ones, One-Weekend with ten spheres duplicated (exact ties)
                  against One-Weekend, One-Weekend beside an icosphere(4),
                  _nee_scene's NEE+MIS (the staged shadow query) and a ragged
                  1283x717 frame; each case's scan (LAST_RUN) gated
 34. bvh_stage    render_kernel's staged BVH route (a block copies a small
                  BVH scene to shared memory once a launch and walks it
                  there) at 1280x720 on stage_scenes' edge cases: the
                  Cornell box, config 3, a stage exactly at the cap and one
                  record above it (the global walk), a sphere BVH beside a
                  mesh, inactive spheres inside leaves, zero-area and
                  edge-on faces, a floor of quads (shared diagonals), 81
                  lights under NEE+MIS and a ragged frame: each launched
                  twice (identical), bit for bit, ray counts included,
                  against the global walk (STAGE_BYTES 0) and
                  render_wavefront without regeneration, on the route
                  pack_scene decides ("+staged" in the launch key)
 35. global_walks the kernels' other global BVH walks (the node and face
                  records in device memory): a 2,500-sphere BVH (above the
                  stage's cap) 640x360 at 4 spp against its plain version,
                  and config 4's mesh through the adaptive kernel (budget
                  16), the normal AOV (against its plain version) and the
                  wavefront bounce (bit-equal to render_cuda), each timed

Every phase that launches the megakernel gates its launch count on its own
route key (megakernel:brute, :sphere_bvh, :mesh_bvh, suffixed +nee,
+sobol/+stratified, +staged, +adaptive and +rays when the launch ran
them: the path loop on a brute scene of at most 1,024 spheres takes the
sphere stage, and phases 7, 9 (config 3), 11 (81 lights) and 12 the BVH
stage); the
wavefront bounce kernel counts under wavefront:<route>[+regen][+rays], its
ray generation under wavefront_raygen, the partition under
wavefront_partition, the loop's step under wavefront_advance, the probes
under fma_peak and bf16_probe.  Then the kernels line (the megakernel once
per path: brute+staged, sphere_bvh, mesh_bvh, mesh_bvh+nee, brute+nee+staged,
brute+sobol+staged,
brute+aov_normal, brute+guides, brute+adaptive, mesh_bvh+nee+adaptive (with
the kernel alone and its cluster size), the hash and sampler probes, wavefront:brute, wavefront:brute+regen,
wavefront_partition (with its kernels' split at both shapes, the pool's
times and a frame's calls, off and on), wavefront_raygen, wavefront_advance,
fma_peak and bf16_probe), each row with its least time
on the card (`bound_ms`, from the rays its counters measured at that row's
shape and, on a brute scan, the share of sphere tests that need roots in
the row's plain version on the same inputs; on the BVH rows the walks that
plain version counted: nodes, faces, sphere tests and roots of its closest
hits, one box and one leaf a shadow ray, with the walk render_kernel took,
its stage's bytes and the blocks an SM), the card's `nvidia-smi` name and power limit, and last
{"ok": true, "device": {...}}.  A failed gate exits nonzero before that line.
Without a CUDA device, or outside the repository, it exits nonzero and prints
no result.  It needs no network and starts no process that outlives it.

    python3 chip_smoke.py --main-path-only

runs phases 1 and 2, then times phase 6's frame over 20 frames through
render() and the kernel alone over 10, the kernel alone on the routes of
configs 3 and 4, the lit path, the night scene and a 1-spp progressive step,
the adaptive main frame (phase 17's), the adaptive Cornell box (phase
15's), the main frame through backend='wavefront' with regeneration off
and on (5 frames each, then a profiled one: device ms by kernel and the
idle share), the denoised main frame (3 frames) and its
launches, render_aov_kernel alone on the three guide passes of that frame,
its guides launch (where the package has render_guides) and config 1, config
1 through render() (40 frames after 2 warm-ups, as phase 10 times it), and
one inverse-rendering step at phase 27's settings (forward and backward,
the median of 5), and prints one JSON line; with `--save-frame PATH` it
also saves the frame as a .npy file, each adaptive frame's image, spp map,
ray counts and six state planes in PATH's stem + "_adaptive.npz", the
AOV planes in PATH's stem + "_aov.npz", the two wavefront frames
(regeneration off and on) in PATH's stem + "_wavefront.npz", and the
frames of the routes timed alone (configs 3 and 4, the Cornell box, the
night scene, the progressive step) in PATH's stem + "_routes.npz", and
phase 35's global walks, timed the same way, in PATH's stem +
"_global.npz".  It also times phase 10's config 4 frame through render()
with the scene on the host and on the card, and pack_scene alone (20
synchronised calls each, host milliseconds).  "The kernel
alone" is the device time of render_cuda calls queued behind a spin
kernel, so the host's packing per call does not show.

    python3 chip_smoke.py --config4-render

runs phases 1 and 2, then only --main-path-only's config 4 timings
(render() with the scene on the host and on the card, pack_scene alone)
over 50 calls each, and prints one JSON line.

    python3 chip_smoke.py --route-variants

runs phases 1 and 2, builds the copies of megakernel.cu that
ROUTE_VARIANTS names (each differing from the checkout's as its name
says), times the kernel alone on the Cornell box and configs 3 and 4 with
the checkout's build, its global walk and each copy in turns, holds each
exact copy's frames to the checkout's, counts the walks of each frame's
plain version, and prints one JSON line.  Copied into
another checkout and run there, it times that checkout's package: run two
checkouts in turns (A, B, B, A) within one machine to compare two builds of
the kernel, and compare their saved frames bit for bit.

    python3 chip_smoke.py --sphere-stage PARENT

runs phases 1 and 2, builds PARENT's megakernel.cu (another checkout's)
beside the checkout's, and prints one JSON line: the sphere-stage
instances' registers, stack and spills and their blocks an SM beside the
parent's render_kernel instances, and the SASS digests the two builds do
not share; it fails unless only the sphere-stage instances differ from
the parent's and they hold at least the parent's blocks an SM.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(REPO, "tests", "goldens")
KERNEL_SOURCE = "gpu_ray_tracing_tpu_torch/ops/cuda/megakernel.cu"
PROBES_SOURCE = "gpu_ray_tracing_tpu_torch/ops/cuda/probes.cu"
REPLACES = "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1420"
WAVEFRONT_REPLACES = "gpu_ray_tracing_tpu/ops/pallas/wavefront.py:87"
WAVEFRONT_SOURCE = "gpu_ray_tracing_tpu_torch/ops/cuda/wavefront.cu"
# The XLA code of the JAX engine's jitted loops that the device loop's
# kernels replace: the compaction under lax.cond in `one_sample`, and the
# ray generation and refill of `_run_regen`.
WAVEFRONT_LOOP_REPLACES = "gpu_ray_tracing_tpu/ops/pallas/wavefront.py:545"
WAVEFRONT_RAYGEN_REPLACES = "gpu_ray_tracing_tpu/ops/pallas/wavefront.py:756"
FMA_PEAK_REPLACES = "benchmarks/vpu_roofline.py:135"
BF16_PROBE_REPLACES = "benchmarks/bf16_probe.py:45"
# The probes launch the kernel's hash and sampler functions alone: the
# draws of `_kernel` (megakernel.py:1509) and its sampler remaps (:1517).
PROBE_REPLACES = {"hash_probe": "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1509",
                  "sampler_probe": "gpu_ray_tracing_tpu/ops/pallas/megakernel.py:1517"}
# The JAX tests' BASE_CAMERA (tests/test_api.py:22-29), and the mesh
# camera of benchmarks/parity_check.py:96-99 and run.py:290-292.
BASE_CAMERA = dict(look_from=[0.0, 0.0, 1.0], look_at=[0.0, 0.0, -1.0],
                   vup=[0.0, 1.0, 0.0], field_of_view=60.0, defocus_angle=0.0,
                   focus_distance=2.0)
MESH_CAMERA = dict(BASE_CAMERA, look_from=[0.0, 1.2, 3.0], look_at=[0.0, 0.7, 0.0])
# The CLI's night camera (gpu_ray_tracing_tpu/cli.py:142-148).
NIGHT_CAMERA = dict(look_from=[0.0, 1.3, 4.0], look_at=[0.0, 0.7, -1.0], vup=[0.0, 1.0, 0.0],
                    field_of_view=45.0, defocus_angle=0.0, focus_distance=10.0)

# The least time of a kernel row, from the H100 SXM's peak rates at 700 W:
# FP32 and BF16 outside the tensor cores (data sheet; the BF16 rate from
# NVIDIA's H100 architecture white paper, twice FP32's), and HBM.
FP32_PEAK = 67e12
BF16_PEAK = 133.8e12
HBM_RATE = 3.35e12
# FP32 operations of one primitive test, counted from the JAX kernel's code
# (a fused multiply-add as 2; compares and selects not counted):
# `_sphere_root` (megakernel.py:530): h 6, cc 8, disc 3 for every test, and
# sqrt(max) 2 and the roots 4 only where the discriminant is not negative
# (elsewhere the closest hit needs no root); the slab test of
# `_traverse_bvh` (:296-318): 12 for the slabs, 10 min/max, the t_min clamp
# 1; `_tri_intersect` (:439): pvec 9, det 5, 1/det 1, tvec 3, u 6, qvec 9,
# v 6, t 6.
SPHERE_TEST_FLOPS = 17
SPHERE_ROOT_FLOPS = 6
BOX_FLOPS = 23
TRI_FLOPS = 45
# `-Xptxas -v` of the one-thread-per-pixel render_kernel<nee, count> this
# tree replaced (commit 2fc7558, nvcc 12.9, on the H100): registers, stack
# bytes and spill-store bytes per instance.
PARENT_RENDER_KERNEL = {"<0,0>": [80, 200, 132], "<0,1>": [80, 200, 140],
                        "<1,0>": [120, 72, 0], "<1,1>": [122, 72, 0]}
# The same for the one-block-per-tile render_adaptive_kernel<nee, count>
# this tree replaced (commit 7dcd714, built with these flags on the H100).
PARENT_ADAPTIVE_KERNEL = {"<0,0>": [80, 184, 200], "<0,1>": [80, 192, 208],
                          "<1,0>": [128, 96, 20], "<1,1>": [128, 96, 24]}

failures: list[str] = []


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def gate(phase: str, ok: bool, what: str) -> None:
    if not ok:
        failures.append(f"{phase}: {what}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_instances(report: str) -> list[str]:
    """`-Xptxas -v`, one line per kernel instance: its mangled name, then
    its stack, spills, registers and shared memory."""
    out, name, frame = [], None, ""
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif name and "stack frame" in ln:
            frame = ln.strip()
        elif name and "registers" in ln:
            out.append(f"{name}: {frame}; {ln.split(':', 1)[1].strip()}")
            name = None
    return out


def kernel_symbol(name: str) -> str:
    """A mangled kernel name without the anonymous namespace's per-file tag
    (and its length), so that two builds of the source (from two paths)
    name it alike."""
    return re.sub(r"\d*_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "", name)


def library_sass(build, library: str) -> dict:
    """A digest of each kernel instance's SASS in `library` (`cuobjdump
    -sass`; addresses dropped, names, also those its calls name, by
    kernel_symbol)."""
    import hashlib

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", library], check=True, capture_output=True,
                          text=True, timeout=300).stdout
    out, name, body = {}, None, []
    for ln in text.splitlines() + ["\tFunction : end"]:
        head = re.match(r"\s+Function : (\S+)", ln)
        if head:
            if name:
                out[name] = hashlib.sha1("\n".join(body).encode()).hexdigest()[:16]
            name = kernel_symbol(head.group(1))
            body = []
        elif name and re.match(r"\s+/\*[0-9a-f]{4}\*/", ln):
            body.append(kernel_symbol(
                re.sub(r"\s*/\*[0-9a-f]{4}\*/\s*", "", ln).split(";")[0].strip()))
    return out


def sass_digests(build, infos: dict) -> dict:
    """A digest of each kernel instance's SASS (library_sass of every built
    library), so that the builds of two checkouts compare function by
    function."""
    out = {}
    for info in infos.values():
        out.update(library_sass(build, info.library))
    return out


def cuda_ms(fn, repeats: int) -> tuple[float, object]:
    """Mean device milliseconds of `repeats` calls of fn (CUDA events)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = None
    for _ in range(repeats):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats, out


# The walks plain_run counted last (walks=True): ops/intersect.BVH_VISITS.
LAST_WALKS: dict = {}


def plain_run(fn, walks: bool = False) -> tuple[float, object, float | None]:
    """cuda_ms(fn, 1) of a plain version's call, and the share of its
    brute-scan (ray, active sphere) tests whose discriminant is not
    negative (ops/intersect.SPHERE_TESTS; None where it ran no brute scan).
    Counting adds a compare and a sum to each scan.  With `walks` it also
    counts the kernel's walks for the plain version's live rays
    ("closest") and shadow rays ("shadow") into LAST_WALKS
    (ops/intersect.BVH_VISITS: nodes, leaves, faces, spheres, roots,
    rays), which replays each query's walk in the kernel's order and adds
    its time to the call's."""
    from gpu_ray_tracing_tpu_torch.ops import intersect
    intersect.SPHERE_TESTS = counts = {"tests": 0, "roots": 0}
    visits = {}
    if walks:
        intersect.BVH_VISITS = visits
    try:
        ms, out = cuda_ms(fn, 1)
    finally:
        intersect.SPHERE_TESTS = None
        intersect.BVH_VISITS = None
    LAST_WALKS.clear()
    LAST_WALKS.update(visits)
    tests = int(counts["tests"])
    return ms, out, int(counts["roots"]) / tests if tests else None


def alone_ms(fn, repeats: int) -> float:
    """The kernel alone: device ms of fn (a launch on tensors already on
    the card), one warm-up call, then the mean of `repeats` calls queued
    behind a ~0.1 s spin kernel.  The host packs a scene in about a
    millisecond a call, so the queue fills before the card reaches it and
    the events see no host time."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    return cuda_ms(fn, repeats)[0]


def kernel_ms(mk, scene, cam, kw: dict, repeats: int) -> float:
    """alone_ms of render_cuda(scene, cam, **kw)."""
    return alone_ms(lambda: mk.render_cuda(scene, cam, **kw), repeats)


def probe_launches(mk, values, samples, salts, pairs) -> dict:
    """The two probe kernels' launchers on tensors packed once on the card
    (the values, salts and outputs the wrappers would make a call), so that
    alone_ms times the kernel and not the wrapper's host copies,
    allocations and u32 conversions; each returns its first output plane,
    to check that it is the wrapper's kernel.  These launches are timings
    and do not count."""
    lib, dev, n = mk.build.load(), values.device, values.numel()
    stream = torch.cuda.current_stream(dev).cuda_stream
    salt_t = torch.tensor(np.asarray(salts, np.uint32).view(np.int32), device=dev)
    hash_out = [torch.empty(n, dtype=torch.int32, device=dev) for _ in range(2)] + [
        torch.empty((len(salts), n), dtype=dt, device=dev) for dt in (torch.int32, torch.float32)]

    def hash_launch(sample_index=5, frame_seed=99):
        mk.build.check(lib.grt_hash_probe(
            values.data_ptr(), n, salt_t.data_ptr(), len(salts), sample_index, frame_seed,
            *[t.data_ptr() for t in hash_out], stream), "hash_probe")
        return hash_out[0]
    pair_t = torch.tensor(pairs, dtype=torch.int32, device=dev)
    uv = [torch.empty((len(pairs), n), dtype=torch.float32, device=dev) for _ in range(2)]

    def sampler_launch(spec, frame_seed=99):
        kind, kx, ky, nbits = mk._sampler_args(spec)
        mk.build.check(lib.grt_sampler_probe(
            values.data_ptr(), samples.data_ptr(), n, pair_t.data_ptr(), len(pairs),
            frame_seed, kind, kx, ky, nbits, uv[0].data_ptr(), uv[1].data_ptr(), stream),
            "sampler_probe")
        return uv[0]
    return dict(hash=hash_launch, sampler=sampler_launch)


def against_plain(T, mk, run, scene, cam, kw, flip: float, mean_tol: float,
                  warmup: int = 1, plain=None, walks: bool = False) -> dict:
    """Reset the launch counts, call `run` (a kernel path) `warmup` times
    and 5 timed times (CUDA events), read the counts, then render the same
    frame with the plain version once (render_reference(scene, cam, **kw);
    its launches do not count; plain_run's root share, and with `walks`
    its counted walks) unless `plain` gives (image, ms, root share)
    already.  The kernel's image is matched to the plain one at (flip,
    mean_tol)."""
    mk.LAUNCHES.clear()
    for _ in range(warmup):
        run()
    ms, img = cuda_ms(run, 5)
    launches = dict(mk.LAUNCHES)
    counted = {}
    if plain is None:
        plain_ms, plain_img, share = plain_run(lambda: mk.render_reference(scene, cam, **kw),
                                               walks)
        counted = dict(LAST_WALKS)
    else:
        plain_img, plain_ms, share = plain
    return dict(img=img, plain_img=plain_img, ms=ms, plain_ms=plain_ms, root_share=share,
                walks=counted,
                launches=launches, finite=bool(torch.isfinite(img).all()),
                mean=float(img.mean()), match=T.images_match(img, plain_img, flip, mean_tol))


def time_main_path(T, mk, repeats: int) -> tuple[float, torch.Tensor, dict]:
    """The main path through render(): One-Weekend at 1280x720, 16 spp,
    depth 30, backend='cuda'; launch counts reset, 2 warm-up frames, then
    the mean ms of `repeats` frames.  Returns (ms, image, launches)."""
    cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, backend="cuda")
    scene, cam = T.one_weekend_scene(0), T.CameraSettings.default()
    mk.LAUNCHES.clear()
    for _ in range(2):
        T.render(scene, cam, cfg, frame_seed=7)
    ms, img = cuda_ms(lambda: T.render(scene, cam, cfg, frame_seed=7), repeats)
    return ms, img, dict(mk.LAUNCHES)


def time_wavefront(T, main_img, repeats: int, arrays: dict | None = None) -> dict:
    """The main frame through render(backend='wavefront'), regeneration off
    and on: one warm-up, then the mean ms of `repeats` frames (CUDA
    events), and whether the frame equals the megakernel's `main_img` bit
    for bit (off) or within 3e-5 (on).  With `arrays` it stores both
    frames there, for a byte comparison between checkouts.  Each mode's
    device time by kernel comes from one more, profiled frame
    (device_breakdown), with the bounce launches the host enqueued."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf

    scene, cam = T.one_weekend_scene(0), T.CameraSettings.default()
    out = {}
    for mode in ("off", "on"):
        cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30,
                             backend="wavefront", regenerate=mode)
        run = lambda: T.render(scene, cam, cfg, frame_seed=7)
        run()
        ms, img = cuda_ms(run, repeats)
        out[mode] = dict(ms_per_frame=ms, max_abs_vs_megakernel=float(
            (img - main_img).abs().max()), bit_equal=bool(torch.equal(img, main_img)),
                         **device_breakdown(run),
                         bounce_launches=wf.LAST_RUN["enqueued"]["bounce"])
        if arrays is not None:
            arrays[mode] = img.cpu().numpy()
    return out


def time_main_kernel(T, mk, repeats: int) -> dict:
    """The main path's kernel alone (kernel_ms over `repeats` launches),
    the rays its counters measure for the frame, and bounce Mrays/s from
    the two."""
    dev = torch.device("cuda", 0)
    scene = T.one_weekend_scene(0).to(dev)
    cam = T.derive_camera(T.CameraSettings.default(), 1280, 720).to(dev)
    kw = dict(width=1280, height=720, spp=16, max_depth=30, t_min=1e-3, frame_seed=7)
    ms = kernel_ms(mk, scene, cam, kw, repeats)
    rays = float(mk.render_cuda(scene, cam, return_ray_count=True, **kw)[1].double().sum())
    return dict(kernel_ms=ms, rays_traced=rays, bounce_mrays_per_s=rays / (ms * 1e3))


AOV_MODES = ("albedo", "normal", "depth")


def main_aov_inputs(T, dev):
    """The denoiser's guide passes at the main frame (One-Weekend,
    1280x720, 16 spp, frame seed 7: render_denoised's own), on the card,
    with render_guides' keywords (a single-mode pass adds max_depth)."""
    scene = T.as_scene(T.one_weekend_scene(0)).to(dev)
    cam = T.derive_camera(T.CameraSettings.default(), 1280, 720).to(dev)
    return scene, cam, dict(width=1280, height=720, spp=16, t_min=1e-3, frame_seed=7)


def time_aov(T, mk, repeats: int, arrays: dict | None = None) -> dict:
    """render_aov_kernel alone (alone_ms over `repeats` launches): the three
    guide passes at the main frame, the guides launch where the package
    has one (mk.render_guides), and BASELINE config 1 (base_scene, 800x600,
    1 spp, the normal AOV; phase 10's frame), and config 1 through
    render() as phase 10 times it (2 warm-ups, then the mean of 4 x
    `repeats` frames).  With `arrays` it stores every plane there, for a
    byte comparison between checkouts."""
    dev = torch.device("cuda", 0)
    scene, cam, kw = main_aov_inputs(T, dev)
    out = {}
    for mode in AOV_MODES:
        single = dict(kw, mode=mode, max_depth=30)
        out[mode] = kernel_ms(mk, scene, cam, single, repeats)
        if arrays is not None:
            arrays["main_" + mode] = mk.render_cuda(scene, cam, **single).cpu().numpy()
    if hasattr(mk, "render_guides"):
        out["guides"] = alone_ms(lambda: mk.render_guides(scene, cam, **kw), repeats)
        if arrays is not None:
            g = mk.render_guides(scene, cam, **kw)
            arrays.update({"guides_" + m: g[m].cpu().numpy() for m in AOV_MODES})
    cfg1 = T.RenderConfig(width=800, height=600, spp=1, integrator="normal")
    base = T.as_scene(T.base_scene()).to(dev)
    bcam = T.derive_camera(T.CameraSettings.make(**BASE_CAMERA), 800, 600).to(dev)
    k1 = dict(width=800, height=600, spp=1, max_depth=cfg1.max_depth, t_min=cfg1.t_min,
              frame_seed=1, mode="normal")
    out["config1"] = kernel_ms(mk, base, bcam, k1, repeats)
    cfg1 = dataclasses.replace(cfg1, backend="cuda")
    base_settings = T.CameraSettings.make(**BASE_CAMERA)
    scene1 = T.as_scene(T.base_scene())
    run1 = lambda: T.render(scene1, base_settings, cfg1, frame_seed=1)
    for _ in range(2):
        run1()
    out["config1_render"] = cuda_ms(run1, 4 * repeats)[0]
    if arrays is not None:
        arrays["config1_normal"] = mk.render_cuda(base, bcam, **k1).cpu().numpy()
    return out


def sphere_cloud(T, n: int, dev, seed: int = 0, inactive_every: int = 0):
    """n spheres for the brute route (as_scene builds no sphere BVH at any
    n; phase 29 and tests/test_torch_cuda.py's guides tests): a ground
    sphere, then random spheres in front of the default camera with
    distinct albedos, and a copy of sphere 1 (a tie the first index must
    win) when n >= 3; with inactive_every k, every k-th sphere after the
    ground has radius 0."""
    rng = np.random.default_rng(seed)
    centers = np.column_stack([rng.uniform(-8, 8, n), rng.uniform(0.1, 2.0, n),
                               rng.uniform(-8, 8, n)]).astype(np.float32)
    radii = rng.uniform(0.15, 0.7, n).astype(np.float32)
    albedo = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)
    kind = rng.integers(0, 3, n).astype(np.int32)
    if n:
        centers[0], radii[0], kind[0] = (0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN
    if n >= 3:
        centers[2], radii[2] = centers[1], radii[1]
    if inactive_every:
        radii[1::inactive_every] = 0.0
    t = lambda a: torch.from_numpy(a).to(dev)
    return T.Spheres(t(centers), t(radii), t(albedo), t(kind),
                     t(rng.uniform(0.0, 1.5, n).astype(np.float32)))


def with_ties(T, spheres, k: int = 10):
    """`spheres` with its k largest appended again in scene order, albedo
    1 - albedo: exact ties that the first index must win, so the frame is
    that of `spheres` (phase 33 and tests/test_torch_cuda.py)."""
    top = torch.argsort(-spheres.radii.cpu(), stable=True)[:k].sort().values
    top = top.to(spheres.radii.device)
    dup = {f.name: getattr(spheres, f.name)[top] for f in dataclasses.fields(T.Spheres)}
    dup["albedo"] = 1.0 - dup["albedo"]
    return T.Spheres(*(torch.cat([getattr(spheres, f.name), dup[f.name]])
                       for f in dataclasses.fields(T.Spheres)))


def active_only(T, spheres):
    """The spheres of radius > 0, in scene order."""
    keep = spheres.radii > 0
    return T.Spheres(*(getattr(spheres, f.name)[keep] for f in dataclasses.fields(T.Spheres)))


def aov_scan_case(T, mk, name: str, scene, cam, kw: dict, twin=None) -> dict:
    """Phase 29, one case: the guides launch twice (identical), each plane
    against its single-mode launch (bit for bit) and against the plain
    version (render_guides_reference, 1% / 2e-4; a scene with no sphere
    must see the sky everywhere instead); with `twin` (another scene that
    must render the same planes) against the twin's guides bit for bit."""
    mk.LAUNCHES.clear()
    g = mk.render_guides(scene, cam, **kw)
    again = mk.render_guides(scene, cam, **kw)
    launches = dict(mk.LAUNCHES)
    r = dict(case=name, spheres=T.as_scene(scene).spheres.count,
             size=[kw["width"], kw["height"]], spp=kw["spp"], launches=launches,
             repeat_equal=all(torch.equal(g[m], again[m]) for m in AOV_MODES),
             single_equal={m: bool(torch.equal(g[m], mk.render_cuda(scene, cam, mode=m,
                                                                    max_depth=1, **kw)))
                           for m in AOV_MODES})
    if r["spheres"]:
        plain = mk.render_guides_reference(scene, cam, **kw)
        ms = {m: T.images_match(g[m], plain[m], 0.01, 2e-4) for m in AOV_MODES}
        r.update(vs_plain={m: [v.flip_frac, v.mean_abs, v.max_abs] for m, v in ms.items()},
                 plain_ok=all(v.ok for v in ms.values()),
                 max_abs=max(v.max_abs for v in ms.values()))
    else:
        r.update(plain_ok=bool(torch.equal(g["albedo"], g["normal"]))
                 and not bool(g["depth"].any()), max_abs=0.0)
    if twin is not None:
        tg = mk.render_guides(twin, cam, **kw)
        r["twin_equal"] = all(torch.equal(g[m], tg[m]) for m in AOV_MODES)
    r["ok"] = (r["repeat_equal"] and all(r["single_equal"].values()) and r["plain_ok"]
               and r.get("twin_equal", True))
    return r


def phase_aov_scan(T, mk, dev, smi: str) -> dict:
    """Phase 29, aov_scan: render_aov_kernel's staged brute scan at
    card-filling sizes (1280x720) through the guides launch, at sphere
    counts around the block (256 threads), the sphere-BVH threshold (256)
    and the staging chunk (1024 spheres), a scene with inactive spheres
    against the scene of its active ones, and a ragged One-Weekend frame."""
    settings = T.CameraSettings.default()
    cam = T.derive_camera(settings, 1280, 720).to(dev)
    rows = []
    for n in (0, 1, 255, 256, 257, 1000, 1024, 1025, 2500):
        kw = dict(width=1280, height=720, spp=1, t_min=1e-3, frame_seed=n)
        rows.append(aov_scan_case(T, mk, f"n={n}", T.as_scene(sphere_cloud(T, n, dev, seed=n)),
                                  cam, kw))
    sp = sphere_cloud(T, 2000, dev, seed=29, inactive_every=3)
    active = active_only(T, sp)
    kw = dict(width=1280, height=720, spp=1, t_min=1e-3, frame_seed=29)
    rows.append(aov_scan_case(T, mk, "inactive_every_3", T.as_scene(sp), cam, kw,
                              twin=T.as_scene(active)))
    odd_cam = T.derive_camera(settings, 1283, 717).to(dev)
    kw = dict(width=1283, height=717, spp=2, t_min=1e-3, frame_seed=5)
    rows.append(aov_scan_case(T, mk, "ragged_1283x717", T.as_scene(T.one_weekend_scene(0)).to(dev),
                              odd_cam, kw))
    emit({"phase": "aov_scan", "cases": rows, "limits": [0.01, 2e-4], "card": smi})
    for r in rows:
        gate("aov_scan", r["ok"], f"{r['case']}: {r}")
        gate("aov_scan", r["launches"] == {"megakernel:brute+guides": 2},
             f"{r['case']}: expected 2 brute guides launches, counted {r['launches']}")
    return dict(launches=sum(r["launches"].get("megakernel:brute+guides", 0) for r in rows),
                max_abs=max(r["max_abs"] for r in rows))


def wf_stage_case(T, mk, wf, dev, name: str, scene, settings, cfg, seed: int,
                  twin=None) -> dict:
    """Phase 33, one case: the frame through render(backend='wavefront'),
    regeneration off and on, against render(backend='cuda') bit for bit,
    and with regeneration off the ray counts of render_wavefront against
    render_cuda's; the bounce kernel's sphere scan (LAST_RUN) and launches;
    with `twin` (a scene that must render the same frame) the twin's frame
    bit for bit."""
    want = T.render(scene, settings, dataclasses.replace(cfg, backend="cuda"), frame_seed=seed)
    r = dict(case=name, spheres=T.as_scene(scene).spheres.count, size=[cfg.width, cfg.height],
             spp=cfg.spp, max_depth=cfg.max_depth)
    ok = True
    for mode in ("off", "on"):
        mk.LAUNCHES.clear()
        got = T.render(scene, settings, dataclasses.replace(cfg, backend="wavefront",
                                                            regenerate=mode), frame_seed=seed)
        launches = {k: v for k, v in mk.LAUNCHES.items() if k.startswith("wavefront:")}
        r[mode] = dict(bit_equal=bool(torch.equal(got, want)),
                       max_abs=float((got - want).abs().max()),
                       sphere_scan=wf.LAST_RUN["sphere_scan"], launches=launches)
        ok = ok and r[mode]["bit_equal"] and sum(launches.values()) > 0
        if twin is not None:
            r[mode]["twin_equal"] = bool(torch.equal(got, T.render(
                twin, settings, dataclasses.replace(cfg, backend="wavefront", regenerate=mode),
                frame_seed=seed)))
            ok = ok and r[mode]["twin_equal"]
    sc = T.as_scene(scene).to(dev)
    cam = T.derive_camera(settings, cfg.width, cfg.height).to(dev)
    kw = render_kw(cfg, seed)
    _, want_rays = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    _, rays = wf.render_wavefront(sc, cam, return_ray_count=True, **kw)
    r["ray_counts_equal"] = bool(torch.equal(rays, want_rays))
    r["rays_traced"] = float(rays.double().sum())
    r["ok"] = ok and r["ray_counts_equal"]
    return r


def phase_wf_stage(T, mk, wf, dev, smi: str) -> dict:
    """Phase 33, wf_stage: the wavefront bounce kernel's staged sphere scan
    at 1280x720 through render(backend='wavefront'), regeneration off and
    on, bit for bit against render(backend='cuda') (whose render_kernel
    scans from device memory), ray counts included: sphere counts around
    the block (256 threads) and the stage (1,024 spheres; 1,025 takes the
    global scan), every third sphere inactive against the scene of its
    active spheres, ten spheres duplicated (exact ties) against the scene
    without them, spheres beside an icosphere(4), NEE+MIS toward sphere
    lights (the staged any-hit) and a ragged 1283x717 frame."""
    settings = T.CameraSettings.default()
    cfg = T.RenderConfig(width=1280, height=720, spp=1, max_depth=8)
    rows = []
    for n in (0, 1, 255, 256, 257, 1024, 1025):
        rows.append(wf_stage_case(T, mk, wf, dev, f"n={n}", T.as_scene(sphere_cloud(T, n, dev, seed=n)),
                                  settings, cfg, n))
    sp = sphere_cloud(T, 1000, dev, seed=33, inactive_every=3)
    rows.append(wf_stage_case(T, mk, wf, dev, "inactive_every_3", T.as_scene(sp), settings, cfg, 33,
                              twin=T.as_scene(active_only(T, sp))))
    ow = T.as_scene(T.one_weekend_scene(0)).spheres
    rows.append(wf_stage_case(T, mk, wf, dev, "ties_10", T.as_scene(with_ties(T, ow)), settings,
                              dataclasses.replace(cfg, spp=2), 10, twin=T.as_scene(ow)))
    ico = T.transform_mesh(T.icosphere(4, albedo=(0.75, 0.6, 0.45), smooth=True), 0.6,
                           (2.0, 0.6, 1.5))
    rows.append(wf_stage_case(T, mk, wf, dev, "one_weekend_icosphere4", T.make_scene(ow, ico),
                              settings, cfg, 4))
    rows.append(wf_stage_case(T, mk, wf, dev, "nee_mis", lit_scenes(T)["nee"],
                              T.CameraSettings.make(**BASE_CAMERA),
                              dataclasses.replace(cfg, spp=2, sky_intensity=0.0, nee=True,
                                                  mis=True, russian_roulette_depth=3), 9))
    rows.append(wf_stage_case(T, mk, wf, dev, "ragged_1283x717", T.one_weekend_scene(0), settings,
                              dataclasses.replace(cfg, width=1283, height=717, spp=2), 5))
    emit({"phase": "wf_stage", "cases": rows, "card": smi})
    for r in rows:
        gate("wf_stage", r["ok"], f"{r['case']}: {r}")
        scan = "global" if r["spheres"] > wf.STAGE_SPHERES else "staged"
        gate("wf_stage", r["off"]["sphere_scan"] == r["on"]["sphere_scan"] == scan,
             f"{r['case']}: expected the {scan} scan, took {r['off']['sphere_scan']}")
    return dict(routes={r["case"]: r["off"]["sphere_scan"] for r in rows},
                launches=sum(sum(r[m]["launches"].values()) for r in rows for m in ("off", "on")))


def _quads(T, quads, **mat_kw):
    """A mesh of two-triangle quads a-b-c-d (winding order)."""
    verts = np.asarray([v for q in quads for v in q], np.float32)
    faces = np.asarray([[4 * i + a, 4 * i + b, 4 * i + c] for i in range(len(quads))
                        for a, b, c in ((0, 1, 2), (0, 2, 3))], np.int64)
    return T.make_mesh(verts, faces, **mat_kw)


def stage_scenes(T, stage_bytes: int) -> dict:
    """The edge cases of render_kernel's BVH stage (phase 34 and
    tests/test_torch_cuda.py), on the CPU: {name: (scene, camera settings,
    render keywords)}.  `stage_bytes` is the stage's cap
    (megakernel.STAGE_BYTES): "at_cap" fills it exactly (a box of 12 faces
    and brute spheres beside it) and "above_cap" holds one sphere more (16
    bytes: the global walk).  "mesh_and_sphere_bvh": a sphere BVH over 300
    spheres beside an icosphere(1); "inactive_in_leaves": a 400-sphere BVH
    whose every fifth sphere is then made inactive inside its leaf (its
    radius negated); "degenerate_faces": zero-area faces (every ray
    near-parallel) and faces edge-on to the camera beside a box;
    "quad_diagonals": a floor of
    8 x 8 quads, so rays land on shared diagonals (equal t on both
    triangles: the first face must win); "many_lights": 81 lights
    (NEE+MIS, one light picked a bounce); "cornell_ragged": the Cornell box
    in a ragged frame."""
    ow_cam = T.CameraSettings.default()
    lk = dict(nee=True, mis=True, sky_intensity=0.0)
    box = T.transform_mesh(T.box(albedo=(0.8, 0.3, 0.2)), 1.2, (0.0, 0.6, -1.0))
    probe = T.make_scene(sphere_cloud(T, 1, "cpu"), box, sphere_bvh=False)
    mesh_bytes = 16 * (3 * probe.mesh.num_triangles + 2 * probe.bvh.num_nodes)
    n_cap = (stage_bytes - mesh_bytes) // 16
    at_cap = T.make_scene(sphere_cloud(T, n_cap, "cpu", seed=34), box, sphere_bvh=False)
    above = T.make_scene(sphere_cloud(T, n_cap + 1, "cpu", seed=34), box, sphere_bvh=False)
    ico = T.transform_mesh(T.icosphere(1, albedo=(0.75, 0.6, 0.45)), 0.8, (1.5, 0.8, 0.5))
    both = T.make_scene(sphere_cloud(T, 300, "cpu", seed=35), ico, sphere_bvh=True)
    holes = T.make_scene(sphere_cloud(T, 400, "cpu", seed=36), sphere_bvh=True)
    radii = holes.spheres.radii.clone()
    radii[1::5] = -radii[1::5]  # inactive, yet a sphere if its sign were ignored
    holes = dataclasses.replace(holes, spheres=dataclasses.replace(holes.spheres, radii=radii))
    # The default camera looks from (13, 2, 3) at the origin: faces in
    # vertical planes through its eye are edge-on to its rays.
    eye = np.asarray([13.0, 2.0, 3.0], np.float32)
    side = np.asarray([-3.0, 0.0, 13.0], np.float32) / np.hypot(3.0, 13.0)
    edge_on = [[eye + a * np.asarray([-13.0, -2.0, -3.0]) / 13.5 + b * np.asarray([0, 1, 0])
                for a, b in ((8, -1), (16, -1), (16, 1), (8, 1))],
               [eye + a * side + b * np.asarray([0, 1, 0]) for a, b in ((-3, -1), (3, -1),
                                                                      (3, 1), (-3, 1))]]
    flat = [[np.asarray(c, np.float32)] * 4 for c in ((0.0, 1.0, 0.0), (2.0, 0.5, -1.0))]
    degenerate = T.make_scene(sphere_cloud(T, 40, "cpu", seed=37), T.merge_meshes(
        box, _quads(T, edge_on, albedo=(0.3, 0.8, 0.3)), _quads(T, flat, albedo=(0.9, 0.9, 0.2))))
    g = np.linspace(-4.0, 4.0, 9)
    tiles = [[(g[i], 0.01, g[j]), (g[i + 1], 0.01, g[j]), (g[i + 1], 0.01, g[j + 1]),
              (g[i], 0.01, g[j + 1])] for i in range(8) for j in range(8)]
    diagonals = T.make_scene(sphere_cloud(T, 30, "cpu", seed=38),
                             _quads(T, tiles, albedo=(0.6, 0.6, 0.6), mat_kind=T.METAL,
                                    mat_param=0.0))
    base = dict(spp=2, max_depth=8)
    return {
        "cornell_nee_mis": (T.cornell_box_scene(), T.cornell_camera(), dict(base, **lk)),
        "config3": (T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11)), ow_cam,
                    dict(spp=1, max_depth=50)),
        "at_cap": (at_cap, ow_cam, base),
        "above_cap": (above, ow_cam, base),
        "mesh_and_sphere_bvh": (both, ow_cam, base),
        "inactive_in_leaves": (holes, ow_cam, base),
        "degenerate_faces": (degenerate, ow_cam, base),
        "quad_diagonals": (diagonals, ow_cam, base),
        "many_lights": (lit_scenes(T)["many_lights"], T.CameraSettings.make(**BASE_CAMERA),
                        dict(spp=2, max_depth=4, **lk)),
        "cornell_ragged": (T.cornell_box_scene(), T.cornell_camera(),
                           dict(base, width=1283, height=717, **lk)),
    }


def bvh_stage_case(T, mk, wf, dev, name: str, scene, cam_s, cfg_kw: dict) -> dict:
    """Phase 34, one case: render_cuda twice with ray counts (identical),
    on the route pack_scene decides (staged when Route.bvh_stage > 0), bit
    for bit against the same frame on the global walk (STAGE_BYTES 0) and
    through the wavefront engine without regeneration (whose bounce walks
    the global arrays), ray counts included."""
    kw = dict(cfg_kw)
    w, h = kw.pop("width", 1280), kw.pop("height", 720)
    sc = T.as_scene(scene).to(dev)
    cam = T.derive_camera(cam_s, w, h).to(dev)
    kw = dict(width=w, height=h, t_min=1e-3, frame_seed=34, **kw)
    stage = mk.route_of(sc).bvh_stage
    mk.LAUNCHES.clear()
    img, rays = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    again, rays_again = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    launches = dict(mk.LAUNCHES)
    cap = mk.STAGE_BYTES
    mk.STAGE_BYTES = 0
    try:
        g_img, g_rays = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
    finally:
        mk.STAGE_BYTES = cap
    w_img, w_rays = wf.render_wavefront(sc, cam, regenerate=False, return_ray_count=True, **kw)
    r = dict(case=name, size=[w, h], spp=kw["spp"], max_depth=kw["max_depth"],
             spheres=sc.spheres.count, faces=0 if sc.mesh is None else sc.mesh.num_triangles,
             stage_bytes=stage, launches=launches,
             repeat_identical=bool(torch.equal(img, again) and torch.equal(rays, rays_again)),
             equals_global=bool(torch.equal(img, g_img) and torch.equal(rays, g_rays)),
             equals_wavefront=bool(torch.equal(img, w_img) and torch.equal(rays, w_rays)),
             max_abs_vs_global=float((img - g_img).abs().max()),
             max_abs_vs_wavefront=float((img - w_img).abs().max()),
             rays_traced=float(rays.double().sum()))
    staged_keys = [k for k in launches if "+staged" in k]
    r["route_ok"] = (sum(launches.values()) == 2
                     and len(staged_keys) == (1 if stage else 0))
    r["ok"] = (r["repeat_identical"] and r["equals_global"] and r["equals_wavefront"]
               and r["route_ok"] and bool(torch.isfinite(img).all()))
    return r


def phase_bvh_stage(T, mk, wf, dev, smi: str) -> dict:
    """Phase 34, bvh_stage: render_kernel's staged BVH route at 1280x720 on
    stage_scenes' edge cases (the Cornell box and config 3 among them), each
    bit for bit against the global walk and the wavefront engine."""
    cases = stage_scenes(T, mk.STAGE_BYTES)
    rows = [bvh_stage_case(T, mk, wf, dev, name, *case) for name, case in cases.items()]
    emit({"phase": "bvh_stage", "cases": rows, "cap_bytes": mk.STAGE_BYTES, "card": smi})
    for r in rows:
        gate("bvh_stage", r["ok"], f"{r['case']}: {r}")
    gate("bvh_stage", [r["stage_bytes"] for r in rows if r["case"] in ("at_cap", "above_cap")]
         == [mk.STAGE_BYTES, 0], "the cap's edge cases took the wrong route")
    return dict(cases=len(rows), staged=sum(1 for r in rows if r["stage_bytes"]),
                launches=sum(sum(r["launches"].values()) for r in rows),
                all_equal=all(r["ok"] for r in rows))


def mesh_scene(T, subdivisions: int):
    """benchmarks/parity_check.py::_mesh_scene, and run.py's config 4 at
    subdivisions=6."""
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])
    ico = T.icosphere(subdivisions, albedo=(0.75, 0.6, 0.45), smooth=True)
    return T.make_scene(ground, T.transform_mesh(ico, 0.8, (0.0, 0.8, 0.0)))


def route_frames(T) -> dict:
    """The frames time_routes times: phases 9, 10, 12 and 11's night case,
    and one 1-spp step of phase 18, each with its phase's seed: {route:
    (scene, camera settings, width, height, render_cuda keywords)}."""
    ow, lk = T.CameraSettings.default(), dict(nee=True, mis=True)
    return {
        "config3": (T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11)), ow,
                    1280, 720, dict(spp=1, max_depth=50, frame_seed=3)),
        "config4": (mesh_scene(T, 6), T.CameraSettings.make(**MESH_CAMERA), 640, 480,
                    dict(spp=1, max_depth=8, frame_seed=4)),
        "cornell_nee_mis": (T.cornell_box_scene(), T.cornell_camera(), 1280, 720,
                            dict(spp=16, max_depth=30, frame_seed=0, sky_intensity=0.0, **lk)),
        "night": (lit_scenes(T)["night"], T.CameraSettings.make(**NIGHT_CAMERA), 320, 180,
                  dict(spp=4, max_depth=30, frame_seed=3, **lk)),
        "progressive_step": (T.one_weekend_scene(0), ow, 1280, 720,
                             dict(spp=1, max_depth=30, frame_seed=7, sample_index=5)),
    }


def route_inputs(T, frame) -> tuple:
    """(scene, camera, render_cuda keywords) of a route_frames entry, on the card."""
    dev = torch.device("cuda", 0)
    scene, cam_s, w, h, kw = frame
    return (T.as_scene(scene).to(dev), T.derive_camera(cam_s, w, h).to(dev),
            dict(width=w, height=h, t_min=1e-3, **kw))


def time_routes(T, mk, repeats: int, arrays: dict | None = None) -> dict:
    """The kernel alone (kernel_ms over `repeats` launches) on each of
    route_frames' frames: {route: ms}; with `arrays` it stores each frame
    there, for a byte comparison between checkouts."""
    out = {}
    for name, frame in route_frames(T).items():
        sc, cam, kw = route_inputs(T, frame)
        out[name] = kernel_ms(mk, sc, cam, kw, repeats)
        if arrays is not None:
            arrays[name] = mk.render_cuda(sc, cam, **kw).cpu().numpy()
    return out


def global_walk_frames(T) -> dict:
    """The kernels' other global BVH walks (config 4 is time_routes'): a
    sphere BVH above the stage's cap (2,500 spheres), and config 4's mesh
    through the adaptive kernel, render_aov_kernel's normal AOV and the
    wavefront bounce (regeneration off): {name: (scene, camera settings,
    width, height, keywords, engine)}, engine "cuda" (render_cuda) or
    "wavefront" (render_wavefront)."""
    ow, mc = T.CameraSettings.default(), T.CameraSettings.make(**MESH_CAMERA)
    ico6 = mesh_scene(T, 6)
    return {
        "sphere_bvh_2500": (T.make_scene(sphere_cloud(T, 2500, "cpu", seed=40), sphere_bvh=True),
                            ow, 640, 360, dict(spp=4, max_depth=8, frame_seed=5), "cuda"),
        "adaptive_mesh": (ico6, mc, 640, 480, dict(spp=16, max_depth=8, frame_seed=6,
                                                   adaptive_tol=0.05, adaptive_min_spp=4),
                          "cuda"),
        "aov_mesh": (ico6, mc, 640, 480, dict(spp=4, max_depth=1, frame_seed=7, mode="normal"),
                     "cuda"),
        "wavefront_mesh": (ico6, mc, 640, 480, dict(spp=1, max_depth=8, frame_seed=4),
                           "wavefront"),
    }


def global_walk_calls(T, mk) -> dict:
    """{name: (scene, camera, keywords, call)} of global_walk_frames on the
    card, each call one frame through its engine."""
    from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf
    out = {}
    for name, (scene, cam_s, w, h, kw, engine) in global_walk_frames(T).items():
        sc, cam, kw = route_inputs(T, (scene, cam_s, w, h, kw))
        if engine == "cuda":
            call = functools.partial(mk.render_cuda, sc, cam, **kw)
        else:
            call = functools.partial(wf.render_wavefront, sc, cam, regenerate=False, **kw)
        out[name] = (sc, cam, kw, call)
    return out


def time_global_walks(T, mk, repeats: int, arrays: dict | None = None) -> dict:
    """Each global_walk_frames frame timed as kernel_ms times a route (the
    wavefront frame with its host enqueue and reads): {name: ms}; with
    `arrays` it stores each frame there, for a byte comparison between
    checkouts."""
    out = {}
    for name, (_, _, _, call) in global_walk_calls(T, mk).items():
        out[name] = alone_ms(call, repeats)
        if arrays is not None:
            arrays[name] = call().cpu().numpy()
    return out


def time_config4_render(T, mk, repeats: int) -> dict:
    """Phase 10's config 4 frame through render(), with the scene on the
    host (render() moves it to the card each call, as phase 10 calls it)
    and with the scene already on the card, and pack_scene alone on the
    card's scene: {name: {median_ms, ms}}, host milliseconds a call, each
    call synchronised.  It calls only entry points that earlier checkouts
    share, so that one copy of this script times a parent and a change."""
    scene, cam = mesh_scene(T, 6), T.CameraSettings.make(**MESH_CAMERA)
    cfg = T.RenderConfig(width=640, height=480, spp=1, max_depth=8, backend="cuda")
    on_card = T.as_scene(scene).to(torch.device("cuda", 0))

    def wall(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return dict(median_ms=float(np.median(ms)), ms=ms)

    return {"render_host_scene": wall(lambda: T.render(scene, cam, cfg, frame_seed=4)),
            "render_card_scene": wall(lambda: T.render(on_card, cam, cfg, frame_seed=4)),
            "pack_scene": wall(lambda: mk.pack_scene(on_card, False, False, None))}


# Copies of megakernel.cu for --route-variants, each differing from it as
# its name says, by (text, replacement) pairs that must each match once:
# the split of the BVH routes' time (the Cornell box, configs 3 and 4) and
# the staged route's design choices.  "shadow_query_none" answers every
# NEE shadow query "not occluded" at once (its frames differ: a timing
# only); the others are exact, and their frames must equal the source's.
# On the global walk: "tri_exit_after_u" leaves Moller-Trumbore after u
# where u cannot hit (the staged walk's too: both call tri_rows), "sphere_root_skip" skips the roots of a negative
# discriminant, "walk_nodes_again" walks each closest hit's BVH a second
# time in its final window without testing a leaf (the time of the nodes
# alone).  On the staged walk: "staged_walk_nodes_again" likewise,
# "staged_tri_exit_after_u" leaves a staged face's test after u where u
# cannot hit and after v where v cannot, "staged_ring16" gives the staged
# route the global route's 16-row ring (more shared memory a block), and
# "staged_min_blocks_6" / "_7" ask the compiler for registers enough for 6
# or 7 blocks an SM (__launch_bounds__).  The global walk's split (config
# 4): "tri_scan_next_leaf" also tests, in each entered mesh leaf, the faces
# of the rows that follow it (as many, its result thrown away: the time of
# the face tests), and "grid_wanted" launches render_kernel on a block a
# 128 pixels instead of the resident blocks (exact: the persistent grid's
# fill and tail).
ROUTE_VARIANTS = {
    "tri_scan_next_leaf": [(
        "      tri_scan(g.faces, start, start + count, t_min, o, d, tb, tri, bu, bv);\n"
        "      return false;\n    });\n",
        "      tri_scan(g.faces, start, start + count, t_min, o, d, tb, tri, bu, bv);\n"
        "      {\n        float tb2 = t_max, bu2 = 0.0f, bv2 = 0.0f;\n        int tri2 = -1;\n"
        "        const int j1 = min(start + 2 * count, g.n_tris);\n"
        "        tri_scan(g.faces, start + count, j1, t_min, o, d, tb2, tri2, bu2, bv2);\n"
        "        if (tri2 == 0x13572468) tb = 0.0f;\n      }\n"
        "      return false;\n    });\n")],
    "grid_wanted": [(
        "      <<<grid_of(wanted, f.resident()), kRegenWarps * 32, smem, s>>>(p);",
        "      <<<grid_of(wanted, wanted), kRegenWarps * 32, smem, s>>>(p);")],
    "shadow_query_none": [(
        "  if (!(window > t_min)) return false;\n  const SphereRay sr = sphere_ray(o, w);",
        "  if (window == window) return false;\n  const SphereRay sr = sphere_ray(o, w);")],
    "tri_exit_after_u": [(
        "  const float u = fdot3(tv.x, tv.y, tv.z, pv.x, pv.y, pv.z) * inv_det;\n  const Vec3 qv",
        "  const float u = fdot3(tv.x, tv.y, tv.z, pv.x, pv.y, pv.z) * inv_det;\n"
        "  if (near_parallel | !(u >= 0.0f) | (u > 1.0f)) return false;\n  const Vec3 qv")],
    "sphere_root_skip": [(
        "  const float disc = fmaf(h, h, -(r.a * cc));\n  const float sq = sqrtf(fmaxf(disc, 0.0f));"
        "\n  const float rn = (h - sq) * r.inv_a;",
        "  const float disc = fmaf(h, h, -(r.a * cc));\n  if (!(disc >= 0.0f)) return false;\n"
        "  const float sq = sqrtf(fmaxf(disc, 0.0f));\n  const float rn = (h - sq) * r.inv_a;")],
    "walk_nodes_again": [(
        "      sphere_scan(sc, n, start, start + count, t_min, o, d, sr, tb, best);\n"
        "      return false;\n    });\n",
        "      sphere_scan(sc, n, start, start + count, t_min, o, d, sr, tb, best);\n"
        "      return false;\n    });\n    int sink = 0;\n"
        "    walk_nodes(g.sphere_bvh.node, o, inv, t_min, tb, [&](int start, int count) {\n"
        "      sink ^= start * 31 + count;\n      return false;\n    });\n"
        "    if (sink == 0x13572468) tb = 0.0f;\n"), (
        "      tri_scan(g.faces, start, start + count, t_min, o, d, tb, tri, bu, bv);\n"
        "      return false;\n    });\n",
        "      tri_scan(g.faces, start, start + count, t_min, o, d, tb, tri, bu, bv);\n"
        "      return false;\n    });\n    int sink = 0;\n"
        "    walk_nodes(g.mesh_bvh.node, o, inv, t_min, tb, [&](int start, int count) {\n"
        "      sink ^= start * 31 + count;\n      return false;\n    });\n"
        "    if (sink == 0x13572468) tb = 0.0f;\n")],
    "staged_walk_nodes_again": [(
        "      staged_range(st.sph, start, start + count, t_min, o, d, sr, tb, best);\n"
        "      return false;\n    });\n",
        "      staged_range(st.sph, start, start + count, t_min, o, d, sr, tb, best);\n"
        "      return false;\n    });\n    int sink = 0;\n"
        "    walk_nodes<true>(st.snode, o, inv, t_min, tb, [&](int start, int count) {\n"
        "      sink ^= start * 31 + count;\n      return false;\n    });\n"
        "    if (sink == 0x13572468) tb = 0.0f;\n"), (
        "          bv = v;\n        }\n      }\n      return false;\n    });\n",
        "          bv = v;\n        }\n      }\n      return false;\n    });\n"
        "    int sink = 0;\n"
        "    walk_nodes<true>(st.mnode, o, inv, t_min, tb, [&](int start, int count) {\n"
        "      sink ^= start * 31 + count;\n      return false;\n    });\n"
        "    if (sink == 0x13572468) tb = 0.0f;\n")],
    "staged_tri_exit_after_u": [(
        "  return tri_rows(f[3 * j], f[3 * j + 1], f[3 * j + 2], t_min, o, d, tb, t_out, u_out,"
        " v_out);\n",
        "  const float4 r0 = f[3 * j], r1 = f[3 * j + 1], r2 = f[3 * j + 2];\n"
        "  const Vec3 v0 = {r0.x, r0.y, r0.z};\n  const Vec3 e1 = {r0.w, r1.x, r1.y};\n"
        "  const Vec3 e2 = {r1.z, r1.w, r2.x};\n"
        "  const Vec3 pv = {fmaf(d.y, e2.z, -(d.z * e2.y)), fmaf(d.z, e2.x, -(d.x * e2.z)),\n"
        "                   fmaf(d.x, e2.y, -(d.y * e2.x))};\n"
        "  const float det = fdot3(e1.x, e1.y, e1.z, pv.x, pv.y, pv.z);\n"
        "  const bool near_parallel = fabsf(det) < 1e-12f;\n"
        "  const float inv_det = 1.0f / (near_parallel ? 1.0f : det);\n"
        "  const Vec3 tv = {o.x - v0.x, o.y - v0.y, o.z - v0.z};\n"
        "  const float u = fdot3(tv.x, tv.y, tv.z, pv.x, pv.y, pv.z) * inv_det;\n"
        "  if (near_parallel | !(u >= 0.0f) | (u > 1.0f)) return false;\n"
        "  const Vec3 qv = {fmaf(tv.y, e1.z, -(tv.z * e1.y)), fmaf(tv.z, e1.x, -(tv.x * e1.z)),\n"
        "                   fmaf(tv.x, e1.y, -(tv.y * e1.x))};\n"
        "  const float v = fdot3(d.x, d.y, d.z, qv.x, qv.y, qv.z) * inv_det;\n"
        "  if (!(v >= 0.0f) | !(u + v <= 1.0f)) return false;\n"
        "  const float t = fdot3(e2.x, e2.y, e2.z, qv.x, qv.y, qv.z) * inv_det;\n"
        "  t_out = t;\n  u_out = u;\n  v_out = v;\n  return (t > t_min) & (t < tb);\n")],
    "staged_ring16": [
        ("constexpr int kStagedRingRows = 8;", "constexpr int kStagedRingRows = 16;"),
        ("static_assert(kRegenWarps * (kRingRows - kStagedRingRows)", "static_assert(true ||"
         " kRegenWarps * (kRingRows - kStagedRingRows)")],
    "staged_min_blocks_6": [(
        "kStage == kSphereStage && !kNee && !kCount ? 6 : 0)",
        "kStage == kBvhStage ? 6 : kStage == kSphereStage && !kNee && !kCount ? 6 : 0)")],
    "staged_min_blocks_7": [(
        "kStage == kSphereStage && !kNee && !kCount ? 6 : 0)",
        "kStage == kBvhStage ? 7 : kStage == kSphereStage && !kNee && !kCount ? 6 : 0)")],
}
# The frames --route-variants times: the BVH routes of route_frames.
VARIANT_ROUTES = ("cornell_nee_mis", "config3", "config4")


def route_variants(T, mk, build, repeats: int, smi: str) -> dict:
    """--route-variants: build the ROUTE_VARIANTS copies of megakernel.cu
    (one nvcc each, side by side, into the build directory), then time the
    kernel alone on VARIANT_ROUTES' frames with the checkout's library, the
    same with no scene staged ("global", where the checkout has a stage)
    and each copy, in turns (source, the others, source, the others
    reversed), each one's frame compared with the source's; and count the
    walks of each frame's plain version (plain_run's walks).  A variant
    whose text does not match the source is reported and not built."""
    import concurrent.futures
    src_path = build.TARGETS["megakernel"].source
    src = open(src_path).read()
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    texts, skipped = {}, {}
    for name, edits in ROUTE_VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                skipped[name] = f"matches {text.count(old)} times: {old[:60]!r}"
                break
            text = text.replace(old, new)
        else:
            path = os.path.join(out_dir, f"megakernel_{name}.cu")
            with open(path, "w") as f:
                f.write(text)
            texts[name] = path
    with concurrent.futures.ThreadPoolExecutor(max(1, len(texts))) as pool:
        built = dict(zip(texts, pool.map(lambda kv: build.compile_copy(
            "megakernel", kv[1], kv[1][:-3] + ".so"), texts.items())))
    base_lib = build.load()
    # "global": the source's library with no scene staged (STAGE_BYTES 0).
    libs = {"source": base_lib, "global": base_lib, **{k: v[0] for k, v in built.items()}}
    frames = {k: route_inputs(T, route_frames(T)[k]) for k in VARIANT_ROUTES}
    order = list(libs) + ["source"] + list(libs)[1:][::-1]
    times = {k: {r: [] for r in frames} for k in libs}
    equal = {k: {} for k in libs if k != "source"}
    want = {r: mk.render_cuda(*inp[:2], **inp[2]) for r, inp in frames.items()}
    cap = mk.STAGE_BYTES
    try:
        for name in order:
            build._libs["megakernel"] = libs[name]
            mk.STAGE_BYTES = 0 if name == "global" else cap
            for r, (sc, cam, kw) in frames.items():
                times[name][r].append(kernel_ms(mk, sc, cam, kw, repeats))
                if name in equal and r not in equal[name]:
                    equal[name][r] = bool(torch.equal(mk.render_cuda(sc, cam, **kw), want[r]))
    finally:
        build._libs["megakernel"] = base_lib
        mk.STAGE_BYTES = cap
    walks = {}
    for r, (sc, cam, kw) in frames.items():
        plain_ms, _, share = plain_run(lambda: mk.render_reference(sc, cam, **kw), walks=True)
        walks[r] = dict(LAST_WALKS, plain_ms=plain_ms, root_share=share)
    return dict(times_ms=times, frame_equals_source=equal, skipped=skipped, walks=walks,
                ptxas={k: [ln for ln in ptxas_instances(v[1]) if "render_kernel" in ln]
                       for k, v in built.items()},
                repeats=repeats, card=smi)


def ptxas_numbers(line: str) -> dict:
    """Registers, stack bytes and spill bytes of one ptxas_instances line."""
    num = lambda pat: int(re.search(pat, line).group(1)) if re.search(pat, line) else None
    return dict(registers=num(r"Used (\d+) registers"), stack=num(r"(\d+) bytes stack frame"),
                spill_stores=num(r"(\d+) bytes spill stores"),
                spill_loads=num(r"(\d+) bytes spill loads"))


def sphere_stage_check(mk, build, parent: str, smi: str) -> dict:
    """--sphere-stage PARENT: render_kernel's sphere stage against PARENT's
    build (another checkout's megakernel.cu, compiled beside the
    checkout's library): the registers, stack and spills of the checkout's
    sphere-stage instances (render_kernel<nee, count, 1>) beside the
    parent's render_kernel instances, their blocks an SM at One-Weekend's
    stage (and a full one) beside the parent's global scan, and the SASS
    digests: which of the parent's no instance of the checkout has, and
    which instances of the checkout have none of the parent's.  Digests
    are compared by body, so the parent's names need not be the
    checkout's."""
    out_dir = os.path.join(build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "megakernel_parent.cu")
    with open(path, "w") as f:
        f.write(open(os.path.join(parent, KERNEL_SOURCE)).read())
    parent_lib, parent_report = build.compile_copy("megakernel", path, path[:-3] + ".so")
    base = build.build_info("megakernel")

    def rows(report, keep):
        return {kernel_symbol(ln.split(":")[0]): ptxas_numbers(ln)
                for ln in ptxas_instances(report) if "render_kernel" in ln and keep(ln)}

    sass = library_sass(build, base.library)
    parent_sass = library_sass(build, path[:-3] + ".so")
    ow, full = mk.sphere_stage_bytes(197), mk.sphere_stage_bytes(mk.STAGE_SPHERES)
    base_lib, blocks = build.load(), {}
    for nee in (False, True):
        for count in (False, True):
            build._libs["megakernel"] = parent_lib
            try:
                parent_global = mk.render_occupancy(nee, count, "global", 0)
            finally:
                build._libs["megakernel"] = base_lib
            blocks[f"<{int(nee)},{int(count)}>"] = dict(
                parent_global=parent_global, spheres=mk.render_occupancy(nee, count, "spheres", ow),
                spheres_full=mk.render_occupancy(nee, count, "spheres", full))
    return dict(stage_bytes=ow, blocks_per_sm=blocks,
                ptxas_stage_instances=rows(base.ptxas_report, lambda ln: "ELi1EEEv" in ln),
                ptxas_parent=rows(parent_report, lambda ln: True),
                sass_instances=len(sass),
                sass_parent_missing=sorted(k for k, v in parent_sass.items()
                                           if v not in set(sass.values())),
                sass_new=sorted(k for k, v in sass.items()
                                if v not in set(parent_sass.values())),
                card=smi)


def regen_schedule(T, mk, wf, cases) -> list[dict]:
    """render_kernel against the wavefront engine with regeneration off
    (the same path_bounce, one launch per bounce, sample by sample: bit-
    equal to the one-thread-per-pixel kernel it replaced) on each case
    (name, scene on the card, camera on the card, render_cuda keywords):
    image and ray counts bit for bit, with and without the counters, and
    two launches identical.  Returns one row a case."""
    rows = []
    for name, sc, cam, kw in cases:
        mk.LAUNCHES.clear()
        got, rays = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
        again, rays_again = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
        no_counter = mk.render_cuda(sc, cam, **kw)
        launches = dict(mk.LAUNCHES)
        want, want_rays = wf.render_wavefront(sc, cam, regenerate=False,
                                              return_ray_count=True, **kw)
        r = dict(case=name, size=[kw["width"], kw["height"]], spp=kw["spp"],
                 image_equal=bool(torch.equal(got, want)),
                 ray_counts_equal=bool(torch.equal(rays, want_rays)),
                 image_equal_without_counter=bool(torch.equal(no_counter, want)),
                 two_runs_identical=bool(torch.equal(got, again)
                                         and torch.equal(rays, rays_again)),
                 max_abs=float((got - want).abs().max()),
                 rays_traced=float(rays.double().sum()), launches=launches)
        r["ok"] = (r["image_equal"] and r["ray_counts_equal"] and r["image_equal_without_counter"]
                   and r["two_runs_identical"] and sum(launches.values()) == 3)
        rows.append(r)
    return rows


def adaptive_frames(T) -> dict:
    """The adaptive frames the A/B times: phase 17's main frame (One-Weekend
    1280x720, budget 32, tol 0.03, min 8, depth 30, seed 7) and phase 15's
    Cornell box (128x96, nee+mis, sky 0, tol 0.5, budget 32, min 4, depth
    8, seed 3), scene and camera on the card: {name: (scene, camera,
    render_cuda keywords)}."""
    dev = torch.device("cuda", 0)
    ow = T.derive_camera(T.CameraSettings.default(), 1280, 720).to(dev)
    cb = T.derive_camera(T.cornell_camera(), 128, 96).to(dev)
    return {
        "adaptive_main": (T.one_weekend_scene(0).to(dev), ow, dict(
            width=1280, height=720, spp=32, max_depth=30, t_min=1e-3, frame_seed=7,
            adaptive_tol=0.03, adaptive_min_spp=8)),
        "adaptive_cornell": (T.cornell_box_scene().to(dev), cb, dict(
            width=128, height=96, spp=32, max_depth=8, t_min=1e-3, frame_seed=3,
            adaptive_tol=0.5, adaptive_min_spp=4, nee=True, mis=True, sky_intensity=0.0)),
    }


def time_adaptive(T, mk, repeats: int, arrays: dict | None = None) -> dict:
    """The adaptive kernel alone (kernel_ms over `repeats` launches) on each
    adaptive frame, with its spp map's mean and its rays; into `arrays`, when
    given, each frame's image, spp map, ray counts and six state planes (the
    one-shot render resumed from zero planes with chunk = budget)."""
    out = {}
    for name, (sc, cam, kw) in adaptive_frames(T).items():
        ms = kernel_ms(mk, sc, cam, kw, repeats)
        img, smap, rays = mk.render_cuda(sc, cam, return_spp_map=True, return_ray_count=True,
                                         **kw)
        zero = tuple(torch.zeros_like(smap) for _ in range(6))
        state = mk.render_cuda(sc, cam, adaptive_state=zero, adaptive_chunk=kw["spp"], **kw)
        out[name] = dict(kernel_ms=ms, spp_mean=float(smap.mean()),
                         rays_traced=float(rays.double().sum()))
        if arrays is not None:
            arrays[name + "_image"] = img.cpu().numpy()
            arrays[name + "_spp_map"] = smap.cpu().numpy()
            arrays[name + "_rays"] = rays.cpu().numpy()
            arrays[name + "_state"] = torch.stack(state).cpu().numpy()
    return out


def adaptive_schedule(T, mk, cases, chunks=(1, 3, 8)) -> list[dict]:
    """render_adaptive_kernel against an oracle that does not depend on its
    schedule, on each case (name, scene on the card, camera on the card,
    render_cuda keywords with the adaptive options, whether to resume): a
    tile whose spp map reads k holds samples 0..k-1 summed in sample order
    and divided by k, which is what the fixed kernel computes, so every
    tile must equal render_cuda(spp=k) there bit for bit, ray counts
    included.  Each frame is launched twice (identical), and again with a
    tile on one block and on 16 (identical to the launcher's choice); with
    `resume`, chunks of 1, 3 and 8 must end in the one-shot's six planes.
    Returns one row a case."""
    rows = []
    for name, sc, cam, kw, resume in cases:
        mk.LAUNCHES.clear()
        got = mk.render_cuda(sc, cam, return_spp_map=True, return_ray_count=True, **kw)
        cluster = mk.adaptive_cluster()
        again = mk.render_cuda(sc, cam, return_spp_map=True, return_ray_count=True, **kw)
        forced = {}
        for blocks in (1, 16):
            mk.adaptive_cluster(blocks)
            forced[blocks] = mk.render_cuda(sc, cam, return_spp_map=True,
                                            return_ray_count=True, **kw)
        mk.adaptive_cluster(0)
        launches = dict(mk.LAUNCHES)
        img, smap, rays = got
        tile_rows = mk.TILE_ROWS if kw.get("mode", "path") == "path" else mk.AOV_TILE_ROWS
        tiles = smap[::tile_rows, ::mk.TILE_COLS]
        per_tile = tiles.repeat_interleave(tile_rows, 0).repeat_interleave(mk.TILE_COLS, 1)
        fixed_kw = {k: v for k, v in kw.items()
                    if k not in ("spp", "adaptive_tol", "adaptive_min_spp")}
        oracle = {}
        for k in sorted({int(v) for v in tiles.flatten().tolist()}):
            f_img, f_rays = mk.render_cuda(sc, cam, spp=k, return_ray_count=True, **fixed_kw)
            m = smap == k
            oracle[k] = bool(torch.equal(f_img[m], img[m]) and torch.equal(f_rays[m], rays[m]))
        same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
        r = dict(case=name, size=[kw["width"], kw["height"]], budget=kw["spp"],
                 cluster_blocks=cluster, tile_spp=tiles.flatten().tolist(),
                 spp_map_tile_constant=bool(torch.equal(smap, per_tile[:smap.shape[0],
                                                                      :smap.shape[1]])),
                 oracle_by_count=oracle, two_runs_identical=same(got, again),
                 one_block_identical=same(got, forced[1]),
                 sixteen_blocks_identical=same(got, forced[16]),
                 rays_traced=float(rays.double().sum()), launches=launches)
        ok = (all(oracle.values()) and r["spp_map_tile_constant"] and r["two_runs_identical"]
              and r["one_block_identical"] and r["sixteen_blocks_identical"] and cluster >= 1)
        if resume:
            zero = tuple(torch.zeros_like(smap) for _ in range(6))
            one = mk.render_cuda(sc, cam, adaptive_state=zero, adaptive_chunk=kw["spp"], **kw)
            r["one_shot_count_is_spp_map"] = bool(torch.equal(one[3], smap))
            r["one_shot_red_mean_equals_frame"] = bool(torch.equal(one[0] / one[3], img[..., 0]))
            for chunk in chunks:
                st = zero
                for _ in range(-(-kw["spp"] // chunk) + 1):
                    st = mk.render_cuda(sc, cam, adaptive_state=st, adaptive_chunk=chunk, **kw)
                r[f"chunk_{chunk}_equals_one_shot"] = same(st, one)
                ok = ok and r[f"chunk_{chunk}_equals_one_shot"]
            ok = ok and r["one_shot_count_is_spp_map"]
        r["ok"] = bool(ok)
        rows.append(r)
    return rows


def adaptive_match(T, img, smap, plain_img, plain_map, flip: float, mean_tol: float):
    """An adaptive frame against its plain version: the count of (32 x 128)
    tiles whose spp differs, and the images matched over the pixels of
    equal-count tiles."""
    tiles_differ = int((smap[::32, ::128] != plain_map[::32, ::128]).sum())
    same = smap == plain_map
    return tiles_differ, T.images_match(img[same][None], plain_img[same][None], flip, mean_tol)


def _mean_leaf(bvh) -> float:
    counts = bvh.leaf_count[bvh.leaf_start >= 0].double()
    return float(counts.mean())


def ray_flops(sc, root_share: float | None) -> float:
    """FP32 operations of the primitive tests one ray needs on a scene's
    route: every active sphere on the brute scan, the roots in
    `root_share` of the tests (plain_run's count; None counts none, a lower
    bound); on a BVH one root-box test plus one leaf of the tree's mean
    size (a lower bound)."""
    sphere = SPHERE_TEST_FLOPS + SPHERE_ROOT_FLOPS * (root_share or 0.0)
    if sc.sphere_bvh is not None:
        flops = BOX_FLOPS + _mean_leaf(sc.sphere_bvh) * sphere
    else:
        flops = float((sc.spheres.radii > 0).sum()) * sphere
    if sc.mesh is not None:
        flops += BOX_FLOPS + _mean_leaf(sc.bvh) * TRI_FLOPS
    return flops


def walk_flops(sc, walks: dict) -> dict:
    """The FP32 work of a frame's walks as plain_run counted them on the
    plain version (walks=True): every closest hit's counted nodes (23
    flops), faces (45) and sphere tests (17, and 6 more for each root),
    and for each shadow ray one box and one leaf of the tree's mean size
    (its any-hit walk ends at the first blocker, which the plain version's
    count does not see: a lower bound).  Returns the flops, the rays they
    cover and each query's counts per ray."""
    c, sh = walks.get("closest", {}), walks.get("shadow", {})
    closest = (c.get("nodes", 0) * BOX_FLOPS + c.get("faces", 0) * TRI_FLOPS
               + c.get("spheres", 0) * SPHERE_TEST_FLOPS + c.get("roots", 0) * SPHERE_ROOT_FLOPS)
    tree, prim = ((sc.bvh, TRI_FLOPS) if sc.mesh is not None
                  else (sc.sphere_bvh, SPHERE_TEST_FLOPS))
    shadow_ray = BOX_FLOPS + (_mean_leaf(tree) * prim if tree is not None else 0.0)
    per_ray = {q: {k: v / w["rays"] for k, v in w.items() if k != "rays"}
               for q, w in walks.items() if w.get("rays")}
    return dict(flops=closest + sh.get("rays", 0) * shadow_ray,
                rays=c.get("rays", 0) + sh.get("rays", 0), per_ray=per_ray,
                shadow_ray_flops=shadow_ray)


def bound(T, mk, sc, rays_traced: float, out_bytes: int, root_share: float | None,
          walks: dict | None = None) -> dict:
    """bound_ms of a megakernel row: the larger of its FP32 work over
    FP32_PEAK and its bytes (the scene's arrays and the camera read once,
    `out_bytes` written once) over HBM_RATE.  The work is, with `walks`
    (plain_run's counted walks on the same inputs), walk_flops' per ray
    times the rays traced; else rays traced x ray_flops at the plain
    version's root share.  Without walks a BVH route's work is a lower
    bound (one box and one leaf a ray), as is a brute scan's with no share
    counted; with them only the shadow rays' part is (walk_flops)."""
    sc = T.as_scene(sc)
    brute = sc.sphere_bvh is None and bool((sc.spheres.radii > 0).any())
    bvh = sc.sphere_bvh is not None or sc.mesh is not None
    lower = (not walks and (bvh or (brute and root_share is None))) or bool(
        walks and walks.get("shadow", {}).get("rays"))
    in_bytes = sum(t.numel() * t.element_size() for t in mk.dataclass_tensors(sc)) + 96
    extra = {}
    if walks:
        wf_ = walk_flops(sc, walks)
        flops = rays_traced * wf_["flops"] / max(wf_["rays"], 1)
        extra = dict(counted_walks=wf_["per_ray"], counted_rays=wf_["rays"],
                     shadow_ray_flops=wf_["shadow_ray_flops"],
                     uncounted_bound_ms=rays_traced * ray_flops(sc, root_share)
                     / FP32_PEAK * 1e3)
    else:
        flops = rays_traced * ray_flops(sc, root_share)
    t_ops = flops / FP32_PEAK * 1e3
    t_bytes = (in_bytes + out_bytes) / HBM_RATE * 1e3
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes
                else "bytes", rays_traced=rays_traced, root_share=root_share,
                bound_is_lower_bound=lower, library_ms=None, **extra)


def bounce_vs_plain(wf, sc, cam, w: int, h: int, *, regen: bool, bounces: int = 6,
                    **engine_kw) -> dict:
    """The wavefront kernels against their plain versions on the (w x h)
    state after ray generation: `bounces` bounces, each fed the KERNEL's
    previous state so that a flipped ray does not compound.  Per bounce:
    the share of live rays whose live flag differs afterwards, and over the
    agreeing rays the mean |difference| of the state planes (rays that go
    on) and of the finished samples (rays that ended).  With `regen` the
    rays mix samples 0-2 and start at bounce 0 or 1."""
    dev, n = sc.device, w * h
    eng = wf.Engine(sc, cam, 3, 30, 1e-3, total_width=w, **engine_kw)
    plain = wf.Engine(sc, cam, 3, 30, 1e-3, total_width=w, plain=True, **engine_kw)
    state_f, state_i = wf.new_state(n, regen, dev)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    state_i[wf.PID], state_i[wf.PIX] = ids, ids
    if regen:
        state_i[wf.SMP] = ids % 3
    pf, pi = state_f.clone(), state_i.clone()
    wf.wavefront_raygen(eng, state_f, state_i, n, regen=regen, sample=1)
    wf.wavefront_raygen(plain, pf, pi, n, regen=regen, sample=1)
    raygen_err = float((state_f - pf).abs().max())
    if regen:
        state_i[wf.BNC] = ids % 2
    samples = 3 if regen else 1
    out = torch.zeros((samples * n, 3), device=dev)
    p_out = torch.zeros_like(out)
    rows = []
    for b in range(bounces):
        before = state_f[wf.LIVE] > 0.5
        slot = state_i[wf.PIX].long() + (state_i[wf.SMP].long() * n if regen else 0)
        pf, pi = state_f.clone(), state_i.clone()
        kw = dict(regen=regen, sample=1, bounce=b, sample_base=0, n_pixels=n)
        wf.wavefront_bounce(eng, state_f, state_i, n, out=out, **kw)
        wf.wavefront_bounce(plain, pf, pi, n, out=p_out, **kw)
        live_k, live_p = state_f[wf.LIVE] > 0.5, pf[wf.LIVE] > 0.5
        agree = before & (live_k == live_p)
        on, ended = agree & live_k, agree & ~live_k
        planes = float((state_f[:wf.LIVE, on] - pf[:wf.LIVE, on]).abs().mean()) if on.any() \
            else 0.0
        done = float((out[slot[ended]] - p_out[slot[ended]]).abs().mean()) if ended.any() \
            else 0.0
        rows.append(dict(bounce=b, live=int(before.sum()),
                         live_differ=float((before & (live_k != live_p)).sum() /
                                           max(int(before.sum()), 1)),
                         planes_mean_abs=planes, finished_mean_abs=done))
    return dict(raygen_max_abs=raygen_err, bounces=rows,
                ok=raygen_err <= 1e-5 and all(
                    r["live_differ"] <= 0.01 and r["planes_mean_abs"] < 2e-4
                    and r["finished_mean_abs"] < 2e-4 for r in rows))


def _clone_array(wf, arr):
    """A copy of a wavefront RayArray (planes, counts, scratch)."""
    twin = wf.RayArray.__new__(wf.RayArray)
    twin.__dict__.update({k: v.clone() if isinstance(v, torch.Tensor) else v
                          for k, v in arr.__dict__.items()})
    return twin


def _fill_match(arr, twin, count: int) -> dict:
    """A stream fill on the card against its plain version: ids and counts
    exactly, rays within 1e-5."""
    ids = bool(torch.equal(arr.i[0, :, :count], twin.i[0, :, :count]))
    counts = bool(torch.equal(arr.ctr, twin.ctr))
    err = float((arr.f[0, :, :count] - twin.f[0, :, :count]).abs().max())
    return dict(fill_ids_equal=ids, fill_counts_equal=counts, fill_max_abs=err,
                fill_ok=ids and counts and err <= 1e-5)


def partition_vs_plain(wf, sc, cam, w: int, h: int, spp: int = 4,
                       sorts=None) -> list[dict]:
    """The device loop's kernels against their plain versions on a real
    state: One-Weekend (w x h), a batch of `spp` samples (or a pool over
    them), filled from the stream on the card and, on a copy of the empty
    array, by the plain fill; two iterations on the card, then one more
    bounce; from that state the partition (wavefront.cu) and, under
    regeneration, the refill (wavefront_raygen_kernel, mode 2) and the
    step, each on the card and as its plain version on a copy.  Per sort
    (`sorts`, default every one) and mode: the filled ids and counts
    exactly and the filled rays within 1e-5 (the plain ray generation's
    rounding on the card), the permutation and the gathered planes
    exactly, the refilled ids exactly and their rays within 1e-5, the
    counts exactly.  Launches made here count under the kernels' keys but
    outside any timed run."""
    dev, p = sc.device, w * h
    frame = dict(p=p, width=w, height=h, y_offset=0, row_stride=1)
    rows = []
    for regen in (False, True):
        for sort in sorts or wf.SORTS:
            eng = wf.Engine(sc, cam, 3, 30, 1e-3, total_width=w)
            plain = wf.Engine(sc, cam, 3, 30, 1e-3, total_width=w, plain=True)
            cap = p if regen else spp * p
            arr = wf.RayArray(cap, regen, sort, dev)
            run = wf._Run(dev, 64)
            out = torch.zeros((spp * p, 3), device=dev)
            sched = wf.Schedule(1.1, 0.25, spp * p, p, regen=regen)
            fresh = _clone_array(wf, arr)
            wf.wavefront_fill(eng, arr, cap, frame, 0, run)
            wf.wavefront_fill(plain, fresh, cap, frame, 0, wf._Run(dev, 1))
            fill = _fill_match(arr, fresh, cap)
            del fresh
            for it in range(2):
                wf._bounce_step(eng, arr, run, bounce=it, sample_base=0, n_pixels=p, out=out)
                wf.wavefront_partition(eng, arr, sched, run)
                if regen:
                    wf.wavefront_refill(eng, arr, sched, frame, 0, run)
                wf.wavefront_advance(eng, arr, sched, run, it)
            wf._bounce_step(eng, arr, run, bounce=2, sample_base=0, n_pixels=p, out=out)
            twin, twin_run = _clone_array(wf, arr), wf._Run(dev, 64)
            twin_run.stats.copy_(run.stats)
            twin_run.iter_live.copy_(run.iter_live)
            pl = wf._plan(arr.ctr, sched)
            wf.wavefront_partition(eng, arr, sched, run)
            wf.wavefront_partition(plain, twin, sched, twin_run)
            torch.cuda.synchronize()
            n, m = pl.n, pl.n if regen else pl.live
            o = pl.cur ^ int(pl.compact)
            r = dict(sort=sort, regenerate=regen, slots=n, live=pl.live, compact=pl.compact,
                     **fill, perm_equal=bool(torch.equal(arr.perm[:n], twin.perm[:n])),
                     planes_equal=bool(torch.equal(arr.f[o, :, :m], twin.f[o, :, :m])
                                       and torch.equal(arr.i[o, :, :m], twin.i[o, :, :m])),
                     planes_max_abs=float((arr.f[o, :, :m] - twin.f[o, :, :m]).abs().max()))
            if regen:
                wf.wavefront_refill(eng, arr, sched, frame, 0, run)
                wf.wavefront_refill(plain, twin, sched, frame, 0, twin_run)
                torch.cuda.synchronize()
                r["refilled"] = pl.k if pl.refill else 0
                r["refill_ids_equal"] = bool(torch.equal(arr.i[o, :, :n], twin.i[o, :, :n]))
                r["refill_max_abs"] = float((arr.f[o, :, :n] - twin.f[o, :, :n]).abs().max())
            wf.wavefront_advance(eng, arr, sched, run, 2)
            wf.wavefront_advance(plain, twin, sched, twin_run, 2)
            r["counts_equal"] = bool(torch.equal(arr.ctr, twin.ctr)
                                     and torch.equal(run.stats, twin_run.stats))
            r["counts_max_abs"] = float(max((arr.ctr - twin.ctr).abs().max(),
                                            (run.stats - twin_run.stats).abs().max()))
            r["ok"] = (r["perm_equal"] and r["planes_equal"] and r["counts_equal"]
                       and fill["fill_ok"] and r.get("refill_ids_equal", True)
                       and r.get("refill_max_abs", 0.0) <= 1e-5 and pl.compact)
            rows.append(r)
    return rows


def library_partition(arr, pl, repeats: int) -> dict:
    """The partition as PyTorch calls (the yardstick; the port never calls
    them): torch.sort(keys, stable=True), whose indices are the permutation
    the partition kernels compute from the same keys (the int16 keys the
    kernels wrote to arr.keys), and index_select of the gathered slots'
    state planes.  Their time alone (alone_ms over `repeats` calls), and
    whether the permutation equals the kernels' (arr.perm)."""
    n, m = pl.n, pl.n if arr.regen else pl.live
    keys, f, i = arr.keys[:n], arr.f[pl.cur], arr.i[pl.cur]

    def call():
        perm = torch.sort(keys, stable=True).indices
        return perm, f.index_select(1, perm[:m]), i.index_select(1, perm[:m])
    ms = alone_ms(call, repeats)
    return dict(library_ms=ms, library_perm_equal=bool(torch.equal(call()[0],
                                                                   arr.perm[:n].long())))


def time_partition(wf, sc, cam, w: int, h: int, spp: int, repeats: int = 10) -> dict:
    """The device loop's kernels at the main path's shape: a batch of `spp`
    samples of the (w x h) frame filled and bounced once on the card, then
    the first compaction (sort 'octant'), the stream fill and the step, each
    timed on the card (CUDA events, the mean of `repeats` calls on a copy
    of the state; the partition alone, behind the spin kernel) and as its
    plain version once; with the least bytes each must move.  The fill and
    the partition are held to their plain versions' results on the same
    state (`match`: as partition_vs_plain).
    The partition is also timed on the regenerating pool's first
    compaction (w x h slots), and at both shapes against its PyTorch
    yardstick (library_partition); at both shapes each partition kernel's
    device ms (partition_split)."""
    dev, p = sc.device, w * h
    frame = dict(p=p, width=w, height=h, y_offset=0, row_stride=1)
    eng = wf.Engine(sc, cam, 7, 30, 1e-3, total_width=w)
    plain = wf.Engine(sc, cam, 7, 30, 1e-3, total_width=w, plain=True)
    arr = wf.RayArray(spp * p, False, "octant", dev)
    run = wf._Run(dev, 30)
    out = torch.zeros((spp * p, 3), device=dev)
    sched = wf.Schedule(0.9)
    fill_ms, _ = cuda_ms(lambda: wf.wavefront_fill(eng, arr, spp * p, frame, 0, run), repeats)
    spare = _clone_array(wf, arr)
    fill_plain_ms, _ = cuda_ms(lambda: wf.wavefront_fill(plain, spare, spp * p, frame, 0,
                                                         wf._Run(dev, 1)), 1)
    match = _fill_match(arr, spare, spp * p)
    del spare
    wf._bounce_step(eng, arr, run, bounce=0, sample_base=0, n_pixels=p, out=out)
    torch.cuda.synchronize()
    pl = wf._plan(arr.ctr, sched)
    twin = _clone_array(wf, arr)
    # Until the step, a partition reads the same counts and buffer: calling
    # it again repeats the same work.
    part_ms = alone_ms(lambda: wf.wavefront_partition(eng, arr, sched), repeats)
    split = partition_split(lambda: wf.wavefront_partition(eng, arr, sched), repeats)
    part_plain_ms, _ = cuda_ms(lambda: wf.wavefront_partition(plain, twin, sched), 1)
    n, m, o = pl.n, pl.live, pl.cur ^ int(pl.compact)
    match.update(perm_equal=bool(torch.equal(arr.perm[:n], twin.perm[:n])),
                 planes_equal=bool(torch.equal(arr.f[o, :, :m], twin.f[o, :, :m])
                                   and torch.equal(arr.i[o, :, :m], twin.i[o, :, :m])),
                 planes_max_abs=float((arr.f[o, :, :m] - twin.f[o, :, :m]).abs().max()))
    match["ok"] = (match["fill_ok"] and match["perm_equal"] and match["planes_equal"]
                   and pl.compact)
    library = library_partition(arr, pl, repeats)
    # The regenerating pool's first compaction: every slot is gathered.
    pool = wf.RayArray(p, True, "octant", dev)
    pool_sched = wf.Schedule(0.9, 0.25, spp * p, p, regen=True)
    pool_run = wf._Run(dev, 30)
    wf.wavefront_fill(eng, pool, p, frame, 0, pool_run)
    wf._bounce_step(eng, pool, pool_run, bounce=0, sample_base=0, n_pixels=p, out=out)
    torch.cuda.synchronize()
    pool_pl = wf._plan(pool.ctr, pool_sched)
    pool_ms = alone_ms(lambda: wf.wavefront_partition(eng, pool, pool_sched), repeats)
    pool_split = partition_split(lambda: wf.wavefront_partition(eng, pool, pool_sched), repeats)
    pool_library = library_partition(pool, pool_pl, repeats)
    del pool
    adv_ms, _ = cuda_ms(lambda: wf.wavefront_advance(eng, arr, sched, run, 0), repeats)
    adv_plain_ms, _ = cuda_ms(lambda: wf.wavefront_advance(plain, twin, sched, run, 0), 1)
    # Keys read the live flag and the direction (16 bytes a slot); the
    # permutation is written once (4); the gather reads and writes the
    # gathered slots' 16 f32 and 3 (pool: 4) i32 planes.
    part_bytes = n * 16 + n * 4 + m * 76 * 2
    pool_bytes = p * 16 + p * 4 + p * 80 * 2
    fill_bytes = n * 76
    return dict(slots=n, live=m, compact=pl.compact, match=match,
                partition=dict(ms=part_ms, plain_ms=part_plain_ms, by_kernel_ms=split,
                               bound_ms=part_bytes / HBM_RATE * 1e3, bound_by="bytes",
                               **library, pool_slots=p, pool_compact=pool_pl.compact,
                               pool_ms=pool_ms, pool_by_kernel_ms=pool_split,
                               pool_bound_ms=pool_bytes / HBM_RATE * 1e3,
                               pool_library_ms=pool_library["library_ms"],
                               pool_library_perm_equal=pool_library["library_perm_equal"]),
                raygen=dict(ms=fill_ms, plain_ms=fill_plain_ms,
                            bound_ms=fill_bytes / HBM_RATE * 1e3, bound_by="bytes"),
                advance=dict(ms=adv_ms, plain_ms=adv_plain_ms,
                             bound_ms=(4 * 8 + 8 * 6) / HBM_RATE * 1e3, bound_by="bytes"))


def _is_partition(name: str) -> bool:
    """Whether a device kernel is one of the partition's (wavefront.cu)."""
    return "wf_" in name and "wf_advance_kernel" not in name


def _kernel_name(name: str) -> str:
    """A kernel's own name in the profiler's demangled signature."""
    m = re.search(r"(\w+_kernel)\b", name)
    return m.group(1) if m else name


def _device_events(fn):
    """The device events of one call of fn (torch.profiler), in start
    order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted((ev for ev in prof.events() if ev.device_type == DeviceType.CUDA),
                  key=lambda ev: ev.time_range.start)


def device_breakdown(fn) -> dict:
    """Device milliseconds of one call of fn by kernel (torch.profiler): the
    wavefront bounce kernel, its ray generation (fill and refill), the
    partition (the wf_ kernels of wavefront.cu but the step; each of them
    apart under `partition_by_kernel_ms`), the loop's step
    (wf_advance_kernel), and everything else (the fold, the fills and
    copies); and from the same call the span from the first kernel's start
    to the last one's end and the share of it in which no kernel ran.  The
    profiler slows the host, so the idle share is that of a profiled
    frame."""
    groups = {"bounce_kernel_ms": 0.0, "raygen_and_refill_kernel_ms": 0.0,
              "partition_kernels_ms": 0.0, "advance_kernel_ms": 0.0, "other_kernels_ms": 0.0}
    split: dict = {}
    first, last = float("inf"), 0.0
    for ev in _device_events(fn):
        ms = ev.time_range.elapsed_us() / 1e3
        key = ("bounce_kernel_ms" if "wavefront_bounce_kernel" in ev.name else
               "raygen_and_refill_kernel_ms" if "wavefront_raygen_kernel" in ev.name else
               "advance_kernel_ms" if "wf_advance_kernel" in ev.name else
               "partition_kernels_ms" if _is_partition(ev.name) else
               "other_kernels_ms")
        groups[key] += ms
        if key == "partition_kernels_ms":
            split[_kernel_name(ev.name)] = split.get(_kernel_name(ev.name), 0.0) + ms
        first, last = min(first, ev.time_range.start), max(last, ev.time_range.end)
    span = (last - first) / 1e3
    return dict(groups, partition_by_kernel_ms=split, profiled_device_span_ms=span,
                device_idle_share=1.0 - sum(groups.values()) / span)


def partition_split(fn, repeats: int) -> dict:
    """Device ms a call of each partition kernel over `repeats` calls of fn
    (torch.profiler, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()

    def calls():
        for _ in range(repeats):
            fn()
    split: dict = {}
    for ev in _device_events(calls):
        if _is_partition(ev.name):
            name = _kernel_name(ev.name)
            split[name] = split.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3 / repeats
    return split


def partition_calls(wf, fn) -> dict:
    """Every partition call of one call of fn (a wavefront frame): the counts
    it read (a device copy of the array's counts taken before the call, read
    after the frame), so its slots n, its live rays, and whether it
    compacted or only ranked a refill's dead slots; and its kernels' device
    ms (torch.profiler: the partition kernels that run between two other
    kernels are one call's).  Returns the list and its sums."""
    snaps = []
    real = wf.wavefront_partition

    def spy(eng, arr, sched, run=None):
        snaps.append((arr.ctr.clone(), sched))
        return real(eng, arr, sched, run)
    wf.wavefront_partition = spy
    try:
        events = _device_events(fn)
    finally:
        wf.wavefront_partition = real
    segments, current = [], None
    for ev in events:
        if not _is_partition(ev.name):
            current = None
            continue
        if current is None:
            current = {}
            segments.append(current)
        name = _kernel_name(ev.name)
        current[name] = current.get(name, 0.0) + ev.time_range.elapsed_us() / 1e3
    rows = []
    for (ctr, sched), kernels in zip(snaps, segments):
        pl = wf._plan(ctr, sched)
        rows.append(dict(n=pl.n, live=pl.live, compact=pl.compact, rank=pl.rank,
                         ms=sum(kernels.values()), kernels=kernels))
    work = [r["ms"] for r in rows if r["compact"] or r["rank"]]
    total = sum(r["ms"] for r in rows)
    return dict(calls=rows, count=len(rows), segments=len(segments), ms=total,
                working_calls=len(work), working_ms=sum(work), idle_calls_ms=total - sum(work))


def lit_scenes(T) -> dict:
    """The lit scenes of benchmarks/parity_check.py (_nee_scene,
    _many_lights_scene) and the CLI's night scene (cli.py:116-123)."""
    em, lam = T.EMISSIVE, T.LAMBERTIAN
    glow = T.transform_mesh(T.icosphere(1, albedo=(0.9, 1.0, 0.8), mat_kind=em, mat_param=3.0),
                            0.5, (-0.8, 1.8, -2.0))
    return {
        "nee": T.make_scene(T.make_spheres([
            ((0, -1000.0, 0), 1000.0, lam, (0.7, 0.7, 0.7), 0.0),
            ((0.0, 2.0, -2.0), 0.3, em, (1.0, 0.9, 0.7), 20.0),
            ((0.8, 0.4, -1.5), 0.4, lam, (0.3, 0.5, 0.8), 0.0)])),
        "many_lights": T.make_scene(T.make_spheres([
            ((0.0, -1000.0, 0.0), 1000.0, lam, (0.7, 0.7, 0.7), 0.0),
            ((2.0, 2.2, -2.0), 0.4, em, (1.0, 0.9, 0.7), 4.0)]), glow),
        "night": T.make_scene(T.make_spheres([
            ((0, -1000.0, 0), 1000.0, lam, (0.65, 0.65, 0.65), 0.0),
            ((0.0, 2.6, -1.0), 0.7, em, (1.0, 0.85, 0.6), 8.0),
            ((-2.4, 0.5, -0.5), 0.5, T.METAL, (0.9, 0.9, 0.95), 0.03),
            ((2.0, 0.5, -1.0), 0.5, T.DIELECTRIC, (1, 1, 1), 1.5),
            ((0.0, 0.5, -1.0), 0.5, lam, (0.2, 0.4, 0.8), 0.0),
            ((-4.5, 1.2, -4.0), 0.8, em, (0.4, 0.6, 1.0), 6.0)])),
    }


# examples/inverse_rendering.py:29-36, the JAX package's inverse-rendering
# camera (its settings: base_scene, 96x72, 4 spp, depth 6, Adam at 0.05).
INVERSE_CAMERA = dict(look_from=[0.0, 0.3, 1.5], look_at=[0.0, 0.0, -1.0],
                      vup=[0.0, 1.0, 0.0], field_of_view=55.0, defocus_angle=0.0,
                      focus_distance=2.5)


def tri_light_scene(T):
    """tests/test_gradients.py's tri-light scene: a floor, a diffuse sphere
    and an emissive quad (two triangle lights)."""
    verts = np.float32([[-0.7, 1.8, -2.7], [0.7, 1.8, -2.7], [0.7, 1.8, -1.3],
                        [-0.7, 1.8, -1.3]])
    quad = T.make_mesh(verts, np.int64([[0, 1, 2], [0, 2, 3]]), albedo=(1.0, 0.9, 0.8),
                       mat_kind=T.EMISSIVE, mat_param=6.0)
    return T.make_scene(T.make_spheres([
        ((0.0, -1000.0, 0.0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((0.3, 0.4, -2.0), 0.4, T.LAMBERTIAN, (0.4, 0.5, 0.8), 0.0)]), quad)


def with_leaves(T, scene, settings):
    """The scene and settings with every float tensor replaced by a fresh
    leaf that requires grad: (scene, settings, {path: leaf})."""
    leaves = {}

    def walk(obj, prefix):
        new = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                new[f.name] = leaves[prefix + f.name] = v.detach().clone().requires_grad_(True)
            elif dataclasses.is_dataclass(v):
                new[f.name] = walk(v, prefix + f.name + ".")
        return dataclasses.replace(obj, **new)

    return walk(T.as_scene(scene), "scene."), walk(settings, "settings."), leaves


def grad_of(T, mk, scene, settings, cfg, weights, seed):
    """d sum(weights * render) for every float leaf of the scene and the
    settings through render(cfg): (image, {path: grad}, launches in the
    forward, launches in the backward)."""
    sc, st, leaves = with_leaves(T, scene, settings)
    mk.LAUNCHES.clear()
    img = T.render(sc, st, cfg, frame_seed=seed)
    fwd = dict(mk.LAUNCHES)
    mk.LAUNCHES.clear()
    (img * weights).sum().backward()
    bwd = dict(mk.LAUNCHES)
    return img.detach(), {k: (torch.zeros_like(v) if v.grad is None else v.grad)
                          for k, v in leaves.items()}, fwd, bwd


def grad_vs_plain(T, mk, dev) -> list[dict]:
    """Phase 26: the gradient through each kernel backend against autograd
    through backend='torch' on the card, per leaf, and the forward against
    the frame rendered without gradients."""
    rows = []
    cases = [("tri_light_nee_mis", tri_light_scene(T), T.CameraSettings.make(**BASE_CAMERA),
              dict(width=24, height=16, spp=2, max_depth=3, sky_intensity=0.0, nee=True,
                   mis=True)),
             ("base_scene", T.base_scene(), T.CameraSettings.make(**BASE_CAMERA),
              dict(width=16, height=12, spp=1, max_depth=4))]
    for case, scene, settings, kw in cases:
        scene, settings = T.as_scene(scene).to(dev), settings.to(dev)
        w = torch.from_numpy(np.random.default_rng(5).random(
            (kw["height"], kw["width"], 3), dtype=np.float32)).to(dev)
        _, want, _, _ = grad_of(T, mk, scene, settings, T.RenderConfig(backend="torch", **kw),
                                w, 3)
        for backend, regen in (("cuda", "off"), ("wavefront", "off"), ("wavefront", "on")):
            cfg = T.RenderConfig(backend=backend, regenerate=regen, **kw)
            img, got, fwd, bwd = grad_of(T, mk, scene, settings, cfg, w, 3)
            with torch.no_grad():
                plain_fwd = T.render(scene, settings, cfg, frame_seed=3)
            leaves = {}
            for k in want:
                g, ref = got[k], want[k]
                leaves[k] = dict(
                    max_abs_diff=float((g - ref).abs().max()),
                    scale=float(ref.abs().max()),
                    ok=bool(torch.isfinite(g).all())
                    and torch.allclose(g, ref, rtol=1e-5, atol=1e-7))
            rows.append(dict(case=case, backend=backend, regenerate=regen,
                             forward_equal=bool(torch.equal(img, plain_fwd)),
                             forward_launches=fwd, backward_launches=bwd, leaves=leaves,
                             albedo_scale=leaves["scene.spheres.albedo"]["scale"],
                             tri_emission_scale=leaves.get("scene.tri_lights.emission",
                                                           {}).get("scale")))
    return rows


def inverse_step(T, scene, settings, cfg, albedo, target, seed):
    """One step of the inverse-rendering loss, mean((render - target)^2)
    with respect to `albedo`: (loss, forward ms, backward ms), host clock
    around each with the card synchronized."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = T.render(dataclasses.replace(scene, albedo=albedo), settings, cfg, frame_seed=seed)
    loss = ((img - target) ** 2).mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3


def inverse_path(T, mk, dev, steps: int = 20) -> dict:
    """Phase 27: examples/inverse_rendering.py's loop on the card, Adam at
    0.05 on a scrambled albedo (numpy seed 123), a fresh frame_seed a step."""
    cfg = T.RenderConfig(width=96, height=72, spp=4, max_depth=6, backend="cuda")
    scene = T.base_scene(device=dev)
    settings = T.CameraSettings.make(**INVERSE_CAMERA, device=dev)
    with torch.no_grad():
        target = T.render(scene, settings, cfg, frame_seed=0)
    rng = np.random.default_rng(123)
    albedo = torch.tensor(rng.random(tuple(scene.albedo.shape), dtype=np.float32), device=dev,
                          requires_grad=True)
    opt = torch.optim.Adam([albedo], lr=0.05)
    err0 = float((albedo.detach() - scene.albedo).abs().max())
    torch.cuda.reset_peak_memory_stats()
    mk.LAUNCHES.clear()
    losses, fwd, bwd = [], [], []
    for i in range(steps):
        opt.zero_grad()
        loss, f_ms, b_ms = inverse_step(T, scene, settings, cfg, albedo, target, 1 + i)
        opt.step()
        with torch.no_grad():
            albedo.clamp_(0.0, 1.0)
        losses.append(loss)
        fwd.append(f_ms)
        bwd.append(b_ms)
    return dict(size=[96, 72], spp=4, max_depth=6, steps=steps, lr=0.05,
                launches=dict(mk.LAUNCHES), loss_first=losses[0], loss_last=losses[-1],
                losses=losses, albedo_err_first=err0,
                albedo_err_last=float((albedo.detach() - scene.albedo).abs().max()),
                forward_ms_median=float(np.median(fwd)),
                backward_ms_median=float(np.median(bwd)),
                step_ms_median=float(np.median(np.add(fwd, bwd))),
                max_memory_allocated_bytes=torch.cuda.max_memory_allocated())


def main_frame_grad(T, mk, dev, seed: int = 7, eps: float = 1e-3) -> dict:
    """Phase 27, second part: d mean(image)/d spheres.albedo of One-Weekend
    at 1280x720, 1 spp, depth 30 through backend='cuda', against central
    differences of render_reference on the same stream at the three entries
    of largest gradient (perturbing albedo moves no hit decision).  The
    perturbation is the f32 difference of the two albedos."""
    from gpu_ray_tracing_tpu_torch.ops import autograd as ag

    w, h = 1280, 720
    cfg = T.RenderConfig(width=w, height=h, spp=1, max_depth=30, backend="cuda")
    scene = T.one_weekend_scene(0, device=dev)
    settings = T.CameraSettings.default(device=dev)
    albedo = scene.albedo.clone().requires_grad_(True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    mk.LAUNCHES.clear()
    t0 = time.perf_counter()
    img = T.render(dataclasses.replace(scene, albedo=albedo), settings, cfg, frame_seed=seed)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img.mean().backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(mk.LAUNCHES)
    g = albedo.grad
    block = ag.replay_block(w * h, T.as_scene(scene), cfg, dev)
    cam = T.derive_camera(settings, w, h)

    def loss(a):
        with torch.no_grad():
            return float(mk.render_reference(
                dataclasses.replace(scene, albedo=a), cam, width=w, height=h, spp=1,
                max_depth=30, t_min=cfg.t_min, frame_seed=seed,
                light_pick="lane").double().mean())

    checks = []
    for flat in torch.argsort(g.abs().flatten(), descending=True)[:3].tolist():
        i, c = divmod(flat, 3)
        hi, lo = scene.albedo.clone(), scene.albedo.clone()
        hi[i, c] += eps
        lo[i, c] -= eps
        fd = (loss(hi) - loss(lo)) / float(hi[i, c] - lo[i, c])
        checks.append(dict(sphere=i, channel=c, grad=float(g[i, c]), fd=fd,
                           rel_err=abs(float(g[i, c]) - fd) / abs(fd)))
    return dict(size=[w, h], spp=1, max_depth=30, spheres=scene.count,
                forward_ms=(t1 - t0) * 1e3, backward_ms=(t2 - t1) * 1e3,
                replay_block_pixels=block, replay_blocks=-(-w * h // block) * cfg.spp,
                peak_memory_bytes=peak, memory_before_bytes=base_mem, launches=launches,
                finite=bool(torch.isfinite(g).all()), nonzero=int((g != 0).sum()),
                fd_eps=eps, fd=checks)


def time_denoised(T, mk, repeats: int) -> dict:
    """render_denoised at the main frame (One-Weekend, 1280x720, 16 spp,
    depth 30, 4 iterations, backend='cuda'): one warm-up, then the mean ms
    of `repeats` frames (CUDA events), the launches of one frame, and the
    last frame with its passes."""
    cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, backend="cuda")
    scene, settings = T.one_weekend_scene(0), T.CameraSettings.default()
    run = lambda: T.render_denoised(scene, settings, cfg, frame_seed=7, return_aovs=True)
    run()
    mk.LAUNCHES.clear()
    run()
    launches = dict(mk.LAUNCHES)
    ms, out = cuda_ms(run, repeats)
    return dict(ms=ms, launches=launches, out=out, cfg=cfg, scene=scene, settings=settings)


def time_inverse_step(T, dev, repeats: int) -> dict:
    """One inverse-rendering step at phase 27's settings (forward through
    the kernel, backward through the replay): medians over `repeats`
    steps after one warm-up."""
    cfg = T.RenderConfig(width=96, height=72, spp=4, max_depth=6, backend="cuda")
    scene = T.base_scene(device=dev)
    settings = T.CameraSettings.make(**INVERSE_CAMERA, device=dev)
    with torch.no_grad():
        target = T.render(scene, settings, cfg, frame_seed=0)
    albedo = torch.full_like(scene.albedo, 0.5).requires_grad_(True)
    steps = [inverse_step(T, scene, settings, cfg, albedo, target, 1 + i)
             for i in range(repeats + 1)][1:]
    return dict(forward_ms=float(np.median([s[1] for s in steps])),
                backward_ms=float(np.median([s[2] for s in steps])))


def filter_device(fn) -> dict:
    """Device ms and CUDA kernel launches of one call of fn
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    return dict(device_ms=sum(ev.time_range.elapsed_us() for ev in evs) / 1e3,
                cuda_kernels=len(evs))


def phase_grad(T, mk, dev, smi: str) -> None:
    """Phase 26, grad_vs_plain: gradients through the kernels
    (ops/autograd.KernelFrame) against autograd through the plain version
    on the card, per leaf."""
    grad_rows = grad_vs_plain(T, mk, dev)
    emit({"phase": "grad_vs_plain", "cases": grad_rows, "bound": [1e-5, 1e-7], "card": smi})
    for r in grad_rows:
        name26 = f"{r['case']} {r['backend']} regenerate={r['regenerate']}"
        bad = [k for k, v in r["leaves"].items() if not v["ok"]]
        gate("grad_vs_plain", not bad, f"{name26}: leaves off the bound: {bad}")
        gate("grad_vs_plain", r["forward_equal"],
             f"{name26}: the forward differs from the frame without gradients")
        gate("grad_vs_plain", r["albedo_scale"] > 0
             and (r["case"] != "tri_light_nee_mis" or (r["tri_emission_scale"] or 0.0) > 0),
             f"{name26}: a zero albedo or tri-light emission gradient")
        # The megakernel once a frame; the wavefront bounce kernel once a
        # bounce of an iteration.
        key = "megakernel:" if r["backend"] == "cuda" else "wavefront:"
        n = sum(v for k, v in r["forward_launches"].items() if k.startswith(key))
        gate("grad_vs_plain", n == 1 if r["backend"] == "cuda" else n >= 1,
             f"{name26}: the forward's {key} launches: {r['forward_launches']}")
        gate("grad_vs_plain", not r["backward_launches"],
             f"{name26}: the backward launched a kernel: {r['backward_launches']}")


def phase_inverse(T, mk, dev, smi: str) -> None:
    """Phase 27, inverse_path: the inverse-rendering loop on the card, then
    one albedo gradient at the main frame's size against finite
    differences."""
    inv = inverse_path(T, mk, dev)
    emit({"phase": "inverse_path", **inv, "card": smi})
    gate("inverse_path", inv["loss_last"] < inv["loss_first"],
         f"the loss did not fall: {inv['loss_first']} -> {inv['loss_last']}")
    gate("inverse_path", inv["albedo_err_last"] < inv["albedo_err_first"],
         f"the albedo error did not fall: {inv['albedo_err_first']} -> "
         f"{inv['albedo_err_last']}")
    gate("inverse_path", inv["launches"] == {"megakernel:brute+staged": 20},
         f"expected 20 staged brute megakernel launches, counted {inv['launches']}")
    mg = main_frame_grad(T, mk, dev)
    emit({"phase": "inverse_path", "main_frame_gradient": mg, "card": smi})
    gate("inverse_path", mg["finite"] and mg["nonzero"] > 0,
         f"main-frame gradient finite {mg['finite']}, nonzero entries {mg['nonzero']}")
    gate("inverse_path", all(c["rel_err"] < 1e-3 for c in mg["fd"]),
         f"main-frame gradient vs finite differences: {mg['fd']}")
    gate("inverse_path", mg["launches"] == {"megakernel:brute+staged": 1},
         f"expected 1 staged brute megakernel launch, counted {mg['launches']}")


def phase_denoise(T, mk, dev, smi: str) -> dict:
    """Phase 28, denoise_path: render_denoised at the main frame timed
    whole and by part (beauty, the guides launch beside the three
    single-mode passes of render_aov_kernel, the filter); each single-mode
    plane equal to the guides launch's bit for bit and to its plain
    version at 1% / 2e-4, the filter on the card against the filter on
    the CPU, the denoised frame against a 256-spp render, and one
    backward (three single-mode passes, the replay needs their graphs).
    Returns the guides launch's kernels-line numbers."""
    den = time_denoised(T, mk, 5)
    out, beauty, aovs = den["out"]
    cfg28 = den["cfg"]
    scene28, cam28, kw28 = main_aov_inputs(T, dev)
    beauty_ms, _ = cuda_ms(lambda: T.render(den["scene"], den["settings"], cfg28,
                                            frame_seed=7), 5)
    mk.LAUNCHES.clear()
    g_img = mk.render_guides(scene28, cam28, **kw28)
    g_key = list(mk.LAUNCHES)
    g_plain_ms, g_plain, g_share = plain_run(
        lambda: mk.render_guides_reference(scene28, cam28, **kw28))
    guides = {}
    for mode in AOV_MODES:
        single = dict(kw28, mode=mode, max_depth=cfg28.max_depth)
        mk.LAUNCHES.clear()
        k_img = mk.render_cuda(scene28, cam28, **single)
        key = list(mk.LAUNCHES)
        p_ms, p_img, p_share = plain_run(lambda: mk.render_reference(scene28, cam28, **single))
        m = T.images_match(k_img, p_img, 0.01, 2e-4)
        guides[mode] = dict(kernel_ms=kernel_ms(mk, scene28, cam28, single, 5),
                            launch_key=key, plain_ms=p_ms, flip_frac=m.flip_frac,
                            mean_abs=m.mean_abs, max_abs=m.max_abs, ok=m.ok,
                            plain_equals_guides_plain=bool(torch.equal(p_img, g_plain[mode])),
                            equal_to_guides_launch=bool(torch.equal(k_img, g_img[mode])),
                            equal_to_render_denoised_pass=bool(torch.equal(k_img, aovs[mode])),
                            **bound(T, mk, scene28, 1280.0 * 720 * 16, 3 * 4 * 1280 * 720,
                                    p_share))
    g_match = {m: T.images_match(g_img[m], g_plain[m], 0.01, 2e-4) for m in AOV_MODES}
    launch = dict(kernel_ms=alone_ms(lambda: mk.render_guides(scene28, cam28, **kw28), 5),
                  launch_key=g_key, plain_ms=g_plain_ms,
                  max_abs=max(v.max_abs for v in g_match.values()),
                  ok=all(v.ok for v in g_match.values()),
                  **bound(T, mk, scene28, 1280.0 * 720 * 16, 3 * 3 * 4 * 1280 * 720, g_share))
    planes = dict(albedo=aovs["albedo"], normal=T.decode_normal_aov(aovs["normal"]),
                  depth=aovs["depth"][..., 0])
    filt = lambda: T.atrous_denoise(beauty, **planes)
    filter_ms, card_out = cuda_ms(filt, 5)
    filt_prof = filter_device(filt)
    t0 = time.perf_counter()
    cpu_out = T.atrous_denoise(beauty.cpu(), **{k: v.cpu() for k, v in planes.items()})
    cpu_s = time.perf_counter() - t0
    filt_match = torch.allclose(card_out.cpu(), cpu_out, rtol=1e-5, atol=1e-7)
    filt_diff = (card_out.cpu() - cpu_out).abs()
    with torch.no_grad():
        ref256 = T.render(den["scene"], den["settings"], dataclasses.replace(cfg28, spp=256),
                          frame_seed=7)
    mse_beauty = float(((beauty - ref256) ** 2).mean())
    mse_out = float(((out - ref256) ** 2).mean())
    albedo28 = scene28.spheres.albedo.clone().requires_grad_(True)
    grad_scene = dataclasses.replace(scene28, spheres=dataclasses.replace(scene28.spheres,
                                                                          albedo=albedo28))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mk.LAUNCHES.clear()
    t0 = time.perf_counter()
    T.render_denoised(grad_scene, den["settings"], cfg28, frame_seed=7).mean().backward()
    torch.cuda.synchronize()
    den_bwd = dict(ms=(time.perf_counter() - t0) * 1e3, launches=dict(mk.LAUNCHES),
                   finite=bool(torch.isfinite(albedo28.grad).all()),
                   nonzero=int((albedo28.grad != 0).sum()),
                   peak_memory_bytes=torch.cuda.max_memory_allocated())
    emit({"phase": "denoise_path", "size": [1280, 720], "spp": 16, "max_depth": 30,
          "iterations": 4, "ms_per_frame": den["ms"], "launches": den["launches"],
          "beauty_ms": beauty_ms, "guides": guides, "guides_launch": launch,
          "guides_launch_vs_plain": {m: [v.flip_frac, v.mean_abs, v.max_abs]
                                     for m, v in g_match.items()},
          "filter_ms": filter_ms,
          "filter_device": filt_prof, "filter_cpu_s": cpu_s,
          "filter_card_vs_cpu_max_abs": float(filt_diff.max()),
          "filter_card_vs_cpu_max_rel": float((filt_diff / cpu_out.abs().clamp(min=1e-6)).max()),
          "filter_card_vs_cpu_ok": filt_match, "mse_beauty_vs_256spp": mse_beauty,
          "mse_denoised_vs_256spp": mse_out, "backward": den_bwd, "card": smi})
    gate("denoise_path", filt_match, f"the filter on the card differs from the CPU's: "
         f"max |diff| {float(filt_diff.max())}")
    for mode, g in guides.items():
        gate("denoise_path", g["ok"], f"{mode} pass vs plain: {g}")
        gate("denoise_path", g["launch_key"] == ["megakernel:brute"],
             f"{mode} pass launched {g['launch_key']}")
        gate("denoise_path", g["equal_to_guides_launch"] and g["equal_to_render_denoised_pass"]
             and g["plain_equals_guides_plain"],
             f"{mode} pass differs from the guides launch's plane: {g}")
    gate("denoise_path", launch["ok"], f"guides launch vs plain: {g_match}")
    gate("denoise_path", g_key == ["megakernel:brute+guides"], f"guides launched {g_key}")
    gate("denoise_path", den["launches"] == {"megakernel:brute+staged": 1,
                                              "megakernel:brute+guides": 1},
         f"expected a beauty and a guides launch a frame, counted {den['launches']}")
    gate("denoise_path", mse_out < mse_beauty,
         f"denoised MSE {mse_out} not below the 16-spp beauty's {mse_beauty}")
    gate("denoise_path", den_bwd["finite"] and den_bwd["nonzero"] > 0,
         f"render_denoised backward: {den_bwd}")
    gate("denoise_path", den_bwd["launches"] == {"megakernel:brute+staged": 1,
                                                  "megakernel:brute": 3},
         f"expected the beauty and three single-mode passes with grad, counted "
         f"{den_bwd['launches']}")
    return dict(launch, launches=den["launches"].get("megakernel:brute+guides", 0),
                denoised_ms=den["ms"])


def run_cli(cli, mk, argv: list[str]) -> tuple[int, str, dict]:
    """cli.main(argv) in this process with the launch counts set to 0
    just before it: (exit code, its standard output, the counts just
    after)."""
    import contextlib
    import io

    mk.LAUNCHES.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), dict(mk.LAUNCHES)


def timed_calls(module, name: str, sink: list):
    """A context in which module.name appends the host seconds of each call,
    the card synchronised at both ends, to `sink`."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        orig = getattr(module, name)

        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig(*args, **kwargs)
            torch.cuda.synchronize()
            sink.append(time.perf_counter() - t0)
            return out

        setattr(module, name, wrapper)
        try:
            yield sink
        finally:
            setattr(module, name, orig)

    return ctx()


def window_ms(frame_fn, frames: int, repeats: int, with_sum: bool) -> dict:
    """ms a frame of `repeats` CUDA-event windows of `frames` frames, frame i
    of window r being frame_fn(r * frames + i), with or without
    time_frames' per-frame sum: the median window and every window."""
    ws = []
    for r in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        acc = None
        for i in range(frames):
            out = frame_fn(r * frames + i)
            if with_sum:
                acc = out.sum() if acc is None else acc + out.sum()
        end.record()
        torch.cuda.synchronize()
        ws.append(start.elapsed_time(end) / frames)
    return dict(median_ms=sorted(ws)[len(ws) // 2], windows_ms=ws)


def phase_cli(T, mk, dev, smi: str, main_ms: float) -> dict:
    """Phase 30: the command line end to end on the card (module
    docstring).  `main_ms` is phase 6's render() ms a frame."""
    import tempfile

    from PIL import Image

    from gpu_ray_tracing_tpu_torch import cli
    from gpu_ray_tracing_tpu_torch.ops import integrators as ti
    from gpu_ray_tracing_tpu_torch.ops import rng as trng
    from gpu_ray_tracing_tpu_torch.utils.checkpoint import load_accum
    from gpu_ray_tracing_tpu_torch.utils import image as image_mod
    from gpu_ray_tracing_tpu_torch.utils.image import to_uint8, tonemap

    row: dict = {"phase": "cli_path", "card": smi}
    small = ["--width", "320", "--height", "180"]
    with tempfile.TemporaryDirectory() as tmp:
        # 1. `python3 -m gpu_ray_tracing_tpu_torch render` at the main path's
        # settings (the CLI's defaults: One-Weekend, 1280x720, 16 spp, depth
        # 30, --backend auto, --device cuda, seed 0), against the API frame.
        out = os.path.join(tmp, "main.png")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "gpu_ray_tracing_tpu_torch", "render", "--out", out],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
            text=True, timeout=300)
        wall = time.perf_counter() - t0
        cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30)
        frame = T.render(T.one_weekend_scene(0), T.CameraSettings.default(), cfg, frame_seed=0)
        api = to_uint8(tonemap(frame))
        written = os.path.exists(out)
        png = np.asarray(Image.open(out)) if written else None
        same = written and png.shape == api.shape and bool(np.array_equal(png, api))
        row["subprocess"] = dict(rc=proc.returncode, wall_s=wall, written=written,
                                 png_equals_api=same, stdout=proc.stdout.strip()[-300:],
                                 differing_bytes=None if not written or png.shape != api.shape
                                 else int((png != api).sum()))
        gate("cli_path", proc.returncode == 0 and written,
             f"subprocess render: rc {proc.returncode}, stderr {proc.stderr[-2000:]}")
        gate("cli_path", same, "the subprocess's PNG differs from the API frame's")

        # The same command in this process, render() and write_image timed
        # inside it: its host seconds outside render() are the parser, the
        # scene, the camera and the image (the copy to the host and the
        # PNG encode).
        render_s, encode_s = [], []
        with timed_calls(T, "render", render_s), timed_calls(image_mod, "write_image",
                                                             encode_s):
            t0 = time.perf_counter()
            rc, _, launches = run_cli(cli, mk, ["render", "--out", os.path.join(tmp, "i.png")])
            wall_in = time.perf_counter() - t0
        row["in_process"] = dict(rc=rc, launches=launches, wall_s=wall_in,
                                 render_s=sum(render_s), write_image_s=sum(encode_s),
                                 outside_render_s=wall_in - sum(render_s),
                                 setup_s=wall_in - sum(render_s) - sum(encode_s))
        gate("cli_path", rc == 0 and launches == {"megakernel:brute+staged": 1},
             f"in-process render: rc {rc}, {launches}")
        gate("cli_path", len(render_s) == 1 and len(encode_s) == 1,
             f"in-process render: {len(render_s)} render() and {len(encode_s)} "
             "write_image calls timed, expected one of each")

        # 2. In process with --bench-frames 20: the written frame, then 3
        # timed windows of 20 frames (time_frames' default repeats).
        rc, text, launches = run_cli(cli, mk, ["render", "--out", os.path.join(tmp, "b.png"),
                                               "--bench-frames", "20"])
        stats = json.loads(text[text.index("{"):]) if "{" in text else {}
        # Beside it in this call, 3 windows of 10 of the CLI's frame seeds:
        # render() as phase 6 calls it (the scene and settings on the host),
        # with and without time_frames' per-frame sum; the scene and
        # settings on the card, the camera derived a frame; and the CLI's
        # inputs, the camera derived once on the card.
        st = T.CameraSettings.default()
        sc_dev, st_dev = T.one_weekend_scene(0, device=dev), st.to(dev)
        cam_dev = T.derive_camera(st_dev, cfg.width, cfg.height)

        def frames(sc, cam, with_sum):
            return window_ms(lambda i: T.render(sc, cam, cfg, frame_seed=i), 10, 3, with_sum)

        row["bench_frames"] = dict(
            rc=rc, launches=launches, frame_stats=stats, render_ms_phase6=main_ms,
            host_inputs_no_sum=frames(T.one_weekend_scene(0), st, False),
            host_inputs_with_sum=frames(T.one_weekend_scene(0), st, True),
            card_settings_with_sum=frames(sc_dev, st_dev, True),
            card_camera_once_with_sum=frames(sc_dev, cam_dev, True))
        mk.LAUNCHES.clear()
        gate("cli_path", rc == 0 and launches == {"megakernel:brute+staged": 1 + 3 * 20},
             f"--bench-frames 20: rc {rc}, expected 61 brute launches, counted {launches}")
        gate("cli_path", stats.get("device") == torch.cuda.get_device_name(0),
             f"--bench-frames timed on {stats.get('device')}")

        # 3. The other engines at 320x180.
        engines = {}
        for name, flags, want in (
                ("denoise", ["--denoise", "4"],
                 lambda c: c == {"megakernel:brute+staged": 1, "megakernel:brute+guides": 1}),
                ("regenerate", ["--regenerate", "on"],
                 lambda c: c.get("wavefront:brute+regen", 0) > 0
                 and c.get("wavefront_raygen", 0) > 0
                 and not any(k.startswith("megakernel:") for k in c)),
                ("adaptive", ["--adaptive-tol", "0.03"],
                 lambda c: c == {"megakernel:brute+adaptive": 1})):
            t0 = time.perf_counter()
            rc, text, launches = run_cli(
                cli, mk, ["render", *small, "--out", os.path.join(tmp, name + ".png"), *flags])
            engines[name] = dict(rc=rc, launches=launches, wall_s=time.perf_counter() - t0,
                                 backend=text.split("backend=")[1].split(",")[0]
                                 if "backend=" in text else None)
            gate("cli_path", rc == 0 and want(launches), f"render {flags}: rc {rc}, {launches}")
        row["engines"] = engines

        # 4. Progressive resume: 2 + 2 steps through a checkpoint equal 4 steps.
        prog = ["progressive", "--checkpoint"]
        ck2, ck4 = os.path.join(tmp, "c2.npz"), os.path.join(tmp, "c4.npz")
        preview = os.path.join(tmp, "p.png")
        rc_a, _, la = run_cli(cli, mk, prog + [ck2, "--steps", "2"])
        rc_b, _, lb = run_cli(cli, mk, prog + [ck2, "--steps", "2", "--out", preview,
                                               "--preview-every", "2"])
        rc_c, _, lc = run_cli(cli, mk, prog + [ck4, "--steps", "4"])
        s2, s4 = load_accum(ck2), load_accum(ck4)
        resume_equal = (int(s2.count) == int(s4.count) == 4
                        and bool(torch.equal(s2.rgb * int(s2.count), s4.rgb * int(s4.count)))
                        and bool(torch.equal(s2.rgb, s4.rgb)))
        preview_written = os.path.exists(os.path.join(tmp, "p_preview.png"))
        row["progressive"] = dict(rc=[rc_a, rc_b, rc_c], launches=[la, lb, lc],
                                  count=int(s2.count), resume_bit_equal=resume_equal,
                                  preview_written=preview_written)
        gate("cli_path", [rc_a, rc_b, rc_c] == [0, 0, 0] and resume_equal,
             "progressive 2 + 2 steps through the checkpoint differ from 4 steps")
        gate("cli_path", preview_written, "--preview-every wrote no preview")
        gate("cli_path", [la, lb, lc] == [{"megakernel:brute+staged": 2},
                                          {"megakernel:brute+staged": 2},
                                          {"megakernel:brute+staged": 4}],
             f"progressive launches {[la, lb, lc]}")

        # 5. animate and view.
        frames_dir = os.path.join(tmp, "frames")
        rc_an, _, l_an = run_cli(cli, mk, ["animate", *small, "--frames", "2",
                                           "--out-dir", frames_dir])
        n_frames = len(os.listdir(frames_dir)) if os.path.isdir(frames_dir) else 0
        rc_v, text_v, l_v = run_cli(cli, mk, ["view", *small, "--no-input", "--max-steps", "3",
                                              "--cols", "80"])
        row["animate"] = dict(rc=rc_an, files=n_frames, launches=l_an)
        row["view"] = dict(rc=rc_v, half_blocks=text_v.count("▀"), launches=l_v,
                           status=[ln for ln in text_v.splitlines() if "spp/step" in ln][-1:])
        gate("cli_path", rc_an == 0 and n_frames == 2
             and l_an == {"megakernel:brute+staged": 2},
             f"animate: rc {rc_an}, {n_frames} files, {l_an}")
        gate("cli_path", rc_v == 0 and text_v.count("▀") >= 80
             and l_v == {"megakernel:brute+staged": 2},
             f"view: rc {rc_v}, {text_v.count('▀')} cells, {l_v}")

    # 6. The WGSL stream on the card: its seeds bit for bit with the CPU's
    # on 1M values, and the parity golden through backend='torch'.
    vals = np.random.default_rng(20261017).random(1 << 20).astype(np.float32) * 1.25 - 0.1
    vals[:6] = [0.0, 1.0, np.nextafter(np.float32(1), np.float32(0)), np.nan, np.inf, -1.0]
    seeds_equal = {
        "pixel_seeds": bool(torch.equal(trng.pixel_seeds(1024, 1024, 5, 99, 7, device=dev).cpu(),
                                        trng.pixel_seeds(1024, 1024, 5, 99, 7))),
        "make_bounce_seeds": bool(torch.equal(
            ti.make_bounce_seeds(torch.tensor(123456789, device=dev), 1 << 20).cpu(),
            ti.make_bounce_seeds(123456789, 1 << 20))),
        "seed_from_f32": bool(torch.equal(trng.seed_from_f32(torch.from_numpy(vals).to(dev)).cpu(),
                                          trng.seed_from_f32(torch.from_numpy(vals)))),
    }
    cfg = T.RenderConfig(width=48, height=32, spp=2, max_depth=6, rng="wgsl", parity=True,
                         backend="torch")
    img = T.render(T.base_scene(device=dev), T.CameraSettings.make(**BASE_CAMERA), cfg,
                   frame_seed=7)
    m = T.images_match(img, np.load(os.path.join(GOLDENS, "base_parity_48x32.npy")),
                       0.005, 1e-4)
    row["wgsl"] = dict(seeds_bit_equal=seeds_equal, golden="base_parity_48x32.npy",
                       device=str(img.device), flip_frac=m.flip_frac, flip_limit=0.005,
                       mean_abs=m.mean_abs, mean_limit=1e-4, max_abs=m.max_abs, ok=m.ok)
    gate("cli_path", all(seeds_equal.values()), f"WGSL seeds on the card: {seeds_equal}")
    gate("cli_path", m.ok and img.device.type == "cuda", f"base_parity on the card: {m}")
    emit(row)
    return row


# --- 31. the sharded path on the card, and 32. the threefry stream ---------

SHARDED_MAIN = dict(width=1280, height=720, spp=16, max_depth=30)  # phase 6's frame
CONFIG5 = dict(width=1920, height=1080, spp=1024, max_depth=20, russian_roulette_depth=5)
SHARDED_ADAPTIVE = dict(width=1280, height=768, spp=32, max_depth=30, adaptive_tol=0.03,
                        adaptive_min_spp=8)
CONFIG5_STEPS = 8


def digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def sharded_job(T, mk, sharding, mesh, job: dict) -> dict:
    """One job of phase 31 on this rank: its readings, every rank's digest
    of what it returned and rank 0's image (numpy, to the parent)."""
    import torch.distributed as dist
    kind, cfg = job["kind"], T.RenderConfig(**job["cfg"])
    scene, cam = T.make_scene(T.one_weekend_scene(0)), T.CameraSettings.default()
    part, seed = job.get("partition", "contiguous"), job.get("seed", 7)
    out = {"rank": dist.get_rank(), "xi": mesh.get_local_rank("x"),
           "si": mesh.get_local_rank("s"), "device": torch.cuda.current_device(),
           "backend": dist.get_backend(mesh.get_group("x"))}
    if kind == "progressive":
        def run():
            st = sharding.shard_accum_state(T.init_accum(cfg.height, cfg.width), mesh)
            for _ in range(job["steps"]):
                st = sharding.progressive_step_sharded(st, scene, cam, cfg, mesh,
                                                       frame_seed=seed, row_partition=part)
            return st
        run()  # warm-up
        repeats = 1
    else:
        def run():
            return sharding.render_sharded(scene, cam, cfg, mesh, frame_seed=seed,
                                           row_partition=part)
        run()
        repeats = job.get("repeats", 3)
    torch.cuda.synchronize()
    mk.LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(repeats):
        res = run()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / repeats
    out["launches"] = dict(mk.LAUNCHES)
    if kind == "progressive":
        out["ms_per_step"] = ms / job["steps"]
        out["band"], out["count"] = list(res.rgb.shape), int(res.count)
        img = sharding.accum_image(res, mesh, part)
    else:
        out["ms_per_frame"], img = ms, res
    out["digest"], out["shape"] = digest(img), list(img.shape)
    out["img"] = img.cpu().numpy() if out["rank"] == 0 else None
    # The collectives of a frame alone: a band's all_reduce over 's' (with
    # spp shards) and its all_gather over 'x', host clock, card synced.
    band = torch.zeros((cfg.height // mesh.size(0), cfg.width, 3), device=img.device)

    def collectives():
        if mesh.size(1) > 1:
            dist.all_reduce(band, group=mesh.get_group("s"))
        return sharding._gather_rows(band, mesh)
    collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        collectives()
    torch.cuda.synchronize()
    out["collective_ms"] = (time.perf_counter() - t0) * 1e3 / 5
    if kind == "adaptive":
        # The band's spp map, through the dispatch render_sharded uses.
        n_rows = mesh.size(0)
        local_h = cfg.height // n_rows
        y0 = out["xi"] * local_h
        band_img, smap = sharding._local_sample(
            T.as_scene(scene).to(img.device), T.derive_camera(cam, cfg.width, cfg.height)
            .to(img.device), cfg, sample_index=0, spp=cfg.spp, frame_seed=seed, y0=y0,
            local_h=local_h, adaptive=True, return_spp_map=True)
        out["y0"], out["spp_map"] = y0, smap.cpu().numpy()
        out["band_equals_image_rows"] = bool(torch.equal(band_img, img[y0:y0 + local_h]))
    return out


def sharded_rank(rank: int, world: int, port: int, backend: str, jobs: list,
                 results) -> None:
    """A rank of phase 31 (a spawned process that imports this file and
    the port, never jax): joins the process group over `backend`, loads
    the parent's build, runs `jobs` on its mesh and puts (rank, job name,
    readings) on `results`.  An error ends the process with its traceback
    and a nonzero exit code, which fails the phase."""
    import datetime

    import torch.distributed as dist
    sys.path.insert(0, REPO)
    import gpu_ray_tracing_tpu_torch as T
    from gpu_ray_tracing_tpu_torch.ops.cuda import build
    from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
    from gpu_ray_tracing_tpu_torch.parallel import mesh as pmesh
    from gpu_ray_tracing_tpu_torch.parallel import sharding

    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        # The parent's build, loaded (compiled only if a source is newer).
        compiled = {name: build.build_info(name).compiled for name in ("megakernel",
                                                                      "wavefront")}
        meshes = {}
        for job in jobs:
            shape = tuple(job["mesh"])
            if shape not in meshes:
                meshes[shape] = pmesh.make_mesh(*shape)
            out = sharded_job(T, mk, sharding, meshes[shape], job)
            results.put((rank, job["name"], dict(out, rank_compiled=compiled)))
    finally:
        dist.destroy_process_group()


def run_ranks(world: int, backend: str, jobs: list, timeout: float = 600) -> tuple[dict, float]:
    """Spawn `world` ranks (rank r on card r % device_count(), make_mesh's
    rule) over `backend` and run `jobs` on each: ({job name: [readings of
    rank r]}, wall seconds).  A rank that exits with an error, or a run past
    `timeout`, fails the phase; every rank still running then is killed."""
    import queue
    import socket

    ctx = torch.multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    results = ctx.Queue()
    procs = [ctx.Process(target=sharded_rank, args=(r, world, port, backend, jobs, results))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got: dict = {}
    expected, n = world * len(jobs), 0
    deadline = time.monotonic() + timeout
    while n < expected:
        try:
            rank, name, out = results.get(timeout=1.0)
        except queue.Empty:
            if (any(p.exitcode not in (None, 0) for p in procs)
                    or time.monotonic() > deadline):
                break
            continue
        got.setdefault(name, {})[rank] = out
        n += 1
    for p in procs:
        p.join(timeout=60 if n == expected else 1)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    gate("sharded", n == expected and codes == [0] * world,
         f"world {world} over {backend}: {n} of {expected} results, exit codes {codes}")
    return ({k: [v.get(r) for r in range(world)] for k, v in got.items()},
            time.perf_counter() - t0)


def phase_sharded(T, mk, dev, smi: str, main_img: torch.Tensor) -> dict:
    """31. render_sharded and progressive_step_sharded on the card through
    K1 and K2, each run against the unsharded frame of its backend: the
    1x1 mesh over nccl (world 1), then 2 and 4 ranks.  Ranks that share a
    card (world > device_count(): one H100) run over gloo with CUDA tensors,
    since nccl puts no two ranks on one device, and their ms are each
    rank's on the shared card, not scaling; with a card a rank they run
    over nccl."""
    main = T.make_scene(T.one_weekend_scene(0))
    cam = T.CameraSettings.default()
    cuda_main = dict(SHARDED_MAIN, backend="cuda")
    wave_main = dict(SHARDED_MAIN, backend="wavefront")
    c5 = dict(CONFIG5, backend="cuda")
    ad = dict(SHARDED_ADAPTIVE, backend="cuda")
    cards = torch.cuda.device_count()
    row = dict(phase="sharded", card=smi, cards=cards, runs={})

    def backend(world: int) -> str:
        return "nccl" if world <= cards else "gloo"

    def frame(name, shape, cfg, partition="contiguous", **kw):
        return dict(name=name, kind="frame", mesh=shape, cfg=cfg, partition=partition, **kw)

    # The unsharded frames of each backend, in this process.
    wave_img = T.render(main, cam, T.RenderConfig(**wave_main), frame_seed=7)
    ad_img, ad_map = T.api._render(main, T.derive_camera(cam, ad["width"], ad["height"]),
                                   T.RenderConfig(**ad), frame_seed=7, spp=ad["spp"],
                                   adaptive=True, return_spp_map=True)
    c5_cfg = T.RenderConfig(**c5)
    c5_state = T.init_accum(c5_cfg.height, c5_cfg.width)
    for _ in range(CONFIG5_STEPS):
        c5_state = T.progressive_step(c5_state, main, cam, c5_cfg, frame_seed=7)
    c5_spp8 = T.render(main, cam, dataclasses.replace(c5_cfg, spp=8), frame_seed=7)
    torch.cuda.synchronize()

    def check(name, outs, want, *, exact=True, key=None, per_rank=1, tol=None):
        """Every rank's digest alike; rank 0's image against `want` (bit
        for bit, or allclose at `tol` = (rtol, atol)); the route key
        launched `per_rank` times a timed run on every rank."""
        img = torch.from_numpy(outs[0]["img"])
        want = want.cpu()
        diff = float((img - want).abs().max())
        same = len({o["digest"] for o in outs}) == 1
        ok = bool(torch.equal(img, want)) if exact else bool(
            torch.allclose(img, want, rtol=tol[0], atol=tol[1]))
        launched = [o["launches"].get(key, 0) for o in outs]
        rec = dict(max_abs_vs_unsharded=diff, bit_equal=bool(torch.equal(img, want)),
                   ranks_agree=same, launches=[o["launches"] for o in outs],
                   backends=sorted({o["backend"] for o in outs}),
                   devices=[o["device"] for o in outs],
                   coords=[[o["xi"], o["si"]] for o in outs],
                   **{k: [o[k] for o in outs] for k in ("ms_per_frame", "ms_per_step",
                                                         "collective_ms", "band", "count")
                      if k in outs[0]})
        row["runs"][name] = rec
        gate("sharded", same, f"{name}: the ranks' images differ")
        gate("sharded", ok, f"{name}: max |diff| {diff} against the unsharded frame "
                            f"({'bit for bit' if exact else tol})")
        gate("sharded", all(n >= per_rank for n in launched),
             f"{name}: {key} launched {launched} times, expected >= {per_rank} a rank")
        return rec

    # World 1 over nccl: the collective backend of a multi-GPU machine.
    outs, secs = run_ranks(1, "nccl", [frame("nccl_1x1", (1, 1), cuda_main)])
    row["world1_nccl_seconds"] = secs
    if "nccl_1x1" in outs:
        check("nccl_1x1", outs["nccl_1x1"], main_img, key="megakernel:brute+staged",
              per_rank=3)
        gate("sharded", outs["nccl_1x1"][0]["backend"] == "nccl",
             f"the 1x1 mesh ran over {outs['nccl_1x1'][0]['backend']}")
    # World 2: rows, both partitions and engines, config 5's interleaved
    # progressive frame, row-sharded adaptive.
    jobs2 = [frame(f"{eng}_2x1_{part}", (2, 1), cfg, part)
             for eng, cfg in (("cuda", cuda_main), ("wavefront", wave_main))
             for part in ("contiguous", "interleaved")]
    jobs2 += [dict(name="config5_2x1_interleaved", kind="progressive", mesh=(2, 1), cfg=c5,
                   partition="interleaved", steps=CONFIG5_STEPS),
              dict(name="adaptive_2x1", kind="adaptive", mesh=(2, 1), cfg=ad, repeats=1)]
    outs2, secs = run_ranks(2, backend(2), jobs2)
    row[f"world2_{backend(2)}_seconds"] = secs
    for eng, want, key in (("cuda", main_img, "megakernel:brute+staged"),
                           ("wavefront", wave_img, "wavefront:brute")):
        for part in ("contiguous", "interleaved"):
            name = f"{eng}_2x1_{part}"
            if name in outs2:
                check(name, outs2[name], want, key=key, per_rank=3)
    if "config5_2x1_interleaved" in outs2:
        o = outs2["config5_2x1_interleaved"]
        rec = check("config5_2x1_interleaved", o, c5_state.rgb, key="megakernel:brute+staged",
                    per_rank=CONFIG5_STEPS)
        gate("sharded", rec["count"] == [CONFIG5_STEPS] * 2 and
             rec["band"] == [[540, 1920, 3]] * 2, f"config 5 state: {rec}")
    if "adaptive_2x1" in outs2:
        o = outs2["adaptive_2x1"]
        rec = check("adaptive_2x1", o, ad_img, key="megakernel:brute+adaptive", per_rank=1)
        maps = [torch.equal(torch.from_numpy(r["spp_map"]),
                            ad_map[r["y0"]:r["y0"] + r["spp_map"].shape[0]].cpu())
                for r in o]
        rec["spp_maps_equal"] = maps
        rec["band_equals_image_rows"] = [r["band_equals_image_rows"] for r in o]
        rec["spp_map_mean"] = float(ad_map.mean())
        gate("sharded", all(maps), f"adaptive 2x1: band spp maps equal {maps}")
        gate("sharded", all(rec["band_equals_image_rows"]),
             "adaptive 2x1: the band with its spp map differs from the sharded image")
    # World 4: 2x2, samples split over 's'.
    jobs4 = [frame("cuda_2x2", (2, 2), cuda_main),
             dict(name="config5_2x2", kind="progressive", mesh=(2, 2), cfg=c5,
                  partition="contiguous", steps=4)]
    outs4, secs = run_ranks(4, backend(4), jobs4)
    row[f"world4_{backend(4)}_seconds"] = secs
    if "cuda_2x2" in outs4:
        check("cuda_2x2", outs4["cuda_2x2"], main_img, exact=False, tol=(1e-5, 1e-6),
              key="megakernel:brute+staged", per_rank=3)
    if "config5_2x2" in outs4:
        rec = check("config5_2x2", outs4["config5_2x2"], c5_spp8, exact=False, tol=(0.0, 2e-5),
                    key="megakernel:brute+staged", per_rank=4)
        gate("sharded", rec["count"] == [8] * 4, f"config 5 2x2 count {rec['count']}")
    emit(row)
    return row


def phase_threefry(T, mk, dev, smi: str) -> dict:
    """32. render(rng='threefry', backend='torch') on the card: One-Weekend
    320x180, depth 8, 256 spp, timed.  jax.random's bits drawn on the card
    equal the CPU's for one key (uniform over 2^21 values and over the
    frame's shapes from a split and fold_in chain); the same key twice
    bit-equal, another key another frame; per-sample frames (render_reference, one sample each)
    whose mean in order is the frame bit for bit, against the hash stream's
    per-sample frames (render_cuda, one sample each): per pixel and channel
    |mean difference| <= 4 standard errors for >= 99%, and the frame means
    within 4 standard errors (tests/test_torch_threefry.py's rule)."""
    w, h, spp, depth = 320, 180, 256, 8
    scene, settings = T.one_weekend_scene(0, device=dev), T.CameraSettings.default()
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=depth, rng="threefry",
                         backend="torch")
    cam = T.derive_camera(settings, w, h).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    a = T.render(scene, cam, cfg, key=21)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    from gpu_ray_tracing_tpu_torch.ops import rng as trng
    key = trng.fold_in(trng.prng_key(21), 3)
    k_ray, k_trace = trng.split(key)
    bits = ((key, (2, 1 << 20)), (trng.split(k_ray)[0], (2, h, w)),
            (trng.fold_in(trng.fold_in(k_trace, 1000), 7), (h * w,)))
    bits_equal = all(torch.equal(trng.uniform(k, shape, dev).cpu().view(torch.int32),
                                 trng.uniform(k, shape).view(torch.int32)) for k, shape in bits)
    same = bool(torch.equal(a, T.render(scene, cam, cfg, key=21)))
    other = not bool(torch.equal(a, T.render(scene, cam, cfg, key=22)))
    kw = dict(width=w, height=h, spp=1, max_depth=depth, t_min=cfg.t_min)
    sums, acc = {}, torch.zeros((h, w, 3), device=dev)
    for rng in ("threefry", "hash"):
        s1 = torch.zeros((h, w, 3), dtype=torch.float64, device=dev)
        s2, means = torch.zeros_like(s1), []
        for s in range(spp):
            if rng == "threefry":
                x = mk.render_reference(scene, cam, sample_index=s, rng="threefry", key=21,
                                        light_pick="lane", **kw)
                acc += x
            else:
                x = mk.render_cuda(scene, cam, sample_index=s, frame_seed=21, **kw)
            xd = x.double()
            s1 += xd
            s2 += xd * xd
            means.append(xd.mean())
        m = torch.stack(means)
        sums[rng] = (s1 / spp, (s2 - s1 * s1 / spp) / (spp - 1), m)
    mean_is_frame = bool(torch.equal(acc / float(spp), a))
    (mt, vt, ft), (mh, vh, fh) = sums["threefry"], sums["hash"]
    se = torch.sqrt(vt.clamp(min=0) / spp + vh.clamp(min=0) / spp)
    within = float(((mt - mh).abs() <= 4 * se + 1e-6).double().mean())
    se_frame = float(torch.sqrt(ft.var() / spp + fh.var() / spp))
    frame_diff = float(ft.mean() - fh.mean())
    row = dict(phase="threefry", size=[w, h], spp=spp, max_depth=depth,
               render_seconds=render_s, card_bits_equal_cpu=bits_equal,
               same_key_bit_equal=same, other_key_differs=other,
               per_sample_mean_is_the_frame=mean_is_frame,
               share_within_4_se=within, frame_mean_diff=frame_diff,
               frame_mean_se=se_frame, mean=float(a.mean()), card=smi)
    emit(row)
    gate("threefry", bits_equal, "the card's threefry bits differ from the CPU's")
    gate("threefry", same and other, f"determinism: same key {same}, other key differs {other}")
    gate("threefry", mean_is_frame, "the per-sample frames' mean is not the frame")
    gate("threefry", within >= 0.99, f"{within:.4f} of pixel channels within 4 SE")
    gate("threefry", abs(frame_diff) <= 4 * se_frame,
         f"frame means differ by {frame_diff}, 4 SE = {4 * se_frame}")
    return row


def phase_global_walks(T, mk, smi: str) -> dict:
    """35. The kernels' other global BVH walks (global_walk_frames), each
    timed as time_global_walks times it: the sphere BVH above the stage's
    cap held to its plain version at the sphere BVH's 2% / 2e-3 and the
    AOV frame at 1% / 2e-4, the wavefront frame bit-equal to render_cuda's
    on the same inputs, the adaptive frame finite with its spp map within
    [min_spp, budget]; each launch counted under its engine's key."""
    calls = global_walk_calls(T, mk)
    mk.LAUNCHES.clear()
    frames = {name: c[3]() for name, c in calls.items()}
    launches = dict(mk.LAUNCHES)
    rows = {}
    for name, (sc, cam, kw, _) in calls.items():
        rows[name] = dict(size=[kw["width"], kw["height"]], spp=kw["spp"],
                          max_depth=kw["max_depth"], stage_bytes=mk.route_of(sc).bvh_stage)
        gate("global_walks", rows[name]["stage_bytes"] == 0, f"{name} is staged")
    for name, flip, mean_tol in (("sphere_bvh_2500", 0.02, 2e-3), ("aov_mesh", 0.01, 2e-4)):
        sc, cam, kw, _ = calls[name]
        plain_ms, plain = cuda_ms(lambda: mk.render_reference(sc, cam, **kw), 1)
        m = T.images_match(frames[name], plain, flip, mean_tol)
        rows[name].update(plain_ms=plain_ms, flip=m.flip_frac, mean_abs=m.mean_abs,
                          max_abs=m.max_abs)
        gate("global_walks", m.ok, f"{name} vs its plain version: {m}")
    sc, cam, kw, _ = calls["wavefront_mesh"]
    wf_equal = bool(torch.equal(frames["wavefront_mesh"], mk.render_cuda(sc, cam, **kw)))
    rows["wavefront_mesh"]["equals_render_cuda"] = wf_equal
    gate("global_walks", wf_equal, "the wavefront mesh frame differs from render_cuda's")
    sc, cam, kw, _ = calls["adaptive_mesh"]
    img, smap = mk.render_cuda(sc, cam, return_spp_map=True, **kw)
    lo, hi = float(smap.min()), float(smap.max())
    rows["adaptive_mesh"].update(spp_min=lo, spp_max=hi, spp_mean=float(smap.mean()))
    gate("global_walks", bool(torch.isfinite(img).all()) and torch.equal(img, frames[
        "adaptive_mesh"]) and kw["adaptive_min_spp"] <= lo <= hi <= kw["spp"],
         f"adaptive mesh frame: spp map {lo}-{hi}")
    for key in ("megakernel:sphere_bvh", "megakernel:mesh_bvh+adaptive", "megakernel:mesh_bvh",
                "wavefront:mesh_bvh"):
        gate("global_walks", launches.get(key, 0) > 0, f"no {key} launch: {launches}")
    ms = time_global_walks(T, mk, 5)
    for name in rows:
        rows[name]["ms"] = ms[name]
    row = dict(phase="global_walks", frames=rows, launches=launches, repeats=5, card=smi)
    emit(row)
    return row


def render_kw(cfg, seed: int) -> dict:
    """render_cuda/render_reference keywords of a RenderConfig frame."""
    return dict(width=cfg.width, height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                t_min=cfg.t_min, frame_seed=seed, sky_intensity=cfg.sky_intensity,
                russian_roulette_depth=cfg.russian_roulette_depth, nee=cfg.nee,
                mis=cfg.mis, sampler_spec=cfg.sampler_spec)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--main-path-only", action="store_true",
                    help="build, time the main path over 20 frames, print one JSON line")
    ap.add_argument("--save-frame", metavar="PATH",
                    help="with --main-path-only: save the timed frame as a .npy file")
    ap.add_argument("--route-variants", action="store_true",
                    help="build, time the BVH routes against copies of megakernel.cu "
                         "(ROUTE_VARIANTS), count their walks, print one JSON line")
    ap.add_argument("--sphere-stage", metavar="PARENT",
                    help="build, compare render_kernel's sphere stage with the checkout "
                         "at PARENT (sphere_stage_check), print one JSON line")
    ap.add_argument("--config4-render", action="store_true",
                    help="build, time config 4 through render() and pack_scene alone "
                         "(time_config4_render, 50 calls each), print one JSON line")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import gpu_ray_tracing_tpu_torch as T
    from gpu_ray_tracing_tpu_torch.ops.cuda import build
    from gpu_ray_tracing_tpu_torch.ops.cuda import megakernel as mk
    if not args.main_path_only:
        from gpu_ray_tracing_tpu_torch.ops.cuda import wavefront as wf
        from gpu_ray_tracing_tpu_torch.utils import roofline

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    # 1. device
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": name, "capability": list(cap),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability (9, 0) for sm_90a, got {cap}",
              file=sys.stderr)
        return 1

    # 2. build
    t0 = time.perf_counter()
    infos = build.build_all()
    emit({"phase": "build", "nvcc": build.build_info("megakernel").nvcc_version,
          "compiled": {k: v.compiled for k, v in infos.items()},
          "nvcc_seconds": {k: v.seconds for k, v in infos.items()},
          "load_seconds": time.perf_counter() - t0, "flags": " ".join(build.NVCC_FLAGS),
          "ptxas": [ln for v in infos.values() for ln in ptxas_instances(v.ptxas_report)],
          "sass_digests": sass_digests(build, infos),
          "render_kernel_parent_regs_stack_spills": PARENT_RENDER_KERNEL,
          "render_adaptive_kernel_parent_regs_stack_spills": PARENT_ADAPTIVE_KERNEL})
    gate("build", all(v.compiled for v in infos.values()),
         "a library was not compiled from the checkout")
    if args.route_variants:
        emit({"phase": "route_variants", **route_variants(T, mk, build, 10, smi)})
        return 0
    if args.sphere_stage:
        row = sphere_stage_check(mk, build, args.sphere_stage, smi)
        emit({"phase": "sphere_stage", **row})
        gate("sphere_stage", not row["sass_parent_missing"],
             f"the parent's SASS that no instance has: {row['sass_parent_missing']}")
        gate("sphere_stage", all("render_kernel" in k and "ELi1EEEv" in k
                                 for k in row["sass_new"]),
             f"instances other than the sphere stage's that differ: {row['sass_new']}")
        gate("sphere_stage", all(b["spheres"] >= b["parent_global"]
                                 for b in row["blocks_per_sm"].values()),
             f"fewer blocks an SM than the parent's: {row['blocks_per_sm']}")
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1 if failures else 0
    if args.config4_render:
        emit({"phase": "config4_render", "repo": REPO, **time_config4_render(T, mk, 50),
              "repeats": 50, "card": smi})
        return 0
    if args.main_path_only:
        ms, img, launches = time_main_path(T, mk, 20)
        arrays = {} if args.save_frame else None
        den = time_denoised(T, mk, 3)
        aov_arrays = {} if args.save_frame else None
        wave_arrays = {} if args.save_frame else None
        route_arrays = {} if args.save_frame else None
        global_arrays = {} if args.save_frame else None
        emit({"phase": "main_path_only", "repo": REPO, "ms_per_frame": ms, "repeats": 20,
              "denoised_ms": den["ms"], "denoised_repeats": 3,
              "denoised_launches": den["launches"],
              "aov_kernel_ms": time_aov(T, mk, 10, aov_arrays), "aov_repeats": 10,
              "inverse_step": time_inverse_step(T, dev, 5), "inverse_repeats": 5,
              **time_main_kernel(T, mk, 10), "kernel_repeats": 10,
              "routes_kernel_ms": time_routes(T, mk, 10, route_arrays),
              "global_walks_ms": time_global_walks(T, mk, 5, global_arrays),
              "global_walks_repeats": 5,
              "config4_render": time_config4_render(T, mk, 20), "config4_render_repeats": 20,
              "adaptive_kernel": time_adaptive(T, mk, 5, arrays), "adaptive_repeats": 5,
              "wavefront": time_wavefront(T, img, 5, wave_arrays), "wavefront_repeats": 5,
              "mean": float(img.mean()), "launches": launches, "card": smi})
        if args.save_frame:
            np.save(args.save_frame, img.cpu().numpy())
            np.savez(os.path.splitext(args.save_frame)[0] + "_adaptive.npz", **arrays)
            np.savez(os.path.splitext(args.save_frame)[0] + "_aov.npz", **aov_arrays)
            np.savez(os.path.splitext(args.save_frame)[0] + "_wavefront.npz", **wave_arrays)
            np.savez(os.path.splitext(args.save_frame)[0] + "_routes.npz", **route_arrays)
            np.savez(os.path.splitext(args.save_frame)[0] + "_global.npz", **global_arrays)
        return 0

    # 3. hash probe
    values = np.random.default_rng(20261016).integers(0, 2**32, 1 << 20, dtype=np.uint64)
    values = values.astype(np.uint32)
    values[:2] = (0, 2**32 - 1)
    vt = torch.from_numpy(values.view(np.int32).copy()).to(dev)
    salts = [1, 2, 3, 4, 16, 17, 18, 1000]
    # The sampler's remaps at pair ids 5-8 (AA, scatter, lens, NEE light 0)
    # on (pixel id, sample) pairs from the same values.
    samples = torch.from_numpy(np.roll(values, 1).view(np.int32).copy()).to(dev)
    pairs = [5, 6, 7, 8]
    launches = probe_launches(mk, vt, samples, salts, pairs)
    got = mk.hash_probe(vt, salts, 5, 99)
    want = mk.hash_probe_reference(vt, salts, 5, 99)
    exact = {k: bool(torch.equal(got[k], want[k])) for k in want}
    same_kernel = bool(torch.equal(mk.rng_ops.as_u32(launches["hash"]()), got["wgsl_hash"]))
    hash_ms = alone_ms(launches["hash"], 5)
    hash_wrapper_ms, _ = cuda_ms(lambda: mk.hash_probe(vt, salts, 5, 99), 5)
    hash_plain_ms, _ = cuda_ms(lambda: mk.hash_probe_reference(vt, salts, 5, 99), 1)
    emit({"phase": "hash_probe", "n": int(values.size), "salts": salts, "bit_exact": exact,
          "ms": hash_ms, "wrapper_ms": hash_wrapper_ms, "plain_ms": hash_plain_ms})
    gate("hash_probe", all(exact.values()), f"hashes differ: {exact}")
    gate("hash_probe", same_kernel, "the timed launch differs from the wrapper's")
    probes = {"hash_probe": dict(launches=mk.LAUNCHES["hash_probe"], ms=hash_ms,
                                 wrapper_ms=hash_wrapper_ms, plain_ms=hash_plain_ms,
                                 max_abs_err=0.0 if all(exact.values()) else float("nan"))}
    mk.LAUNCHES.clear()
    errs, sampler_ms, sampler_wrapper_ms, sampler_plain_ms = [], 0.0, 0.0, 0.0
    for spec in (("stratified", 4, 4), ("sobol", 5)):
        got = mk.sampler_probe(vt, samples, 99, spec, pairs)
        want = mk.sampler_probe_reference(vt, samples, 99, spec, pairs)
        exact = all(torch.equal(got[k], want[k]) for k in want)
        errs.append(max(float((got[k] - want[k]).abs().max()) for k in want))
        same_kernel = bool(torch.equal(launches["sampler"](spec), got["u1"]))
        t_k = alone_ms(lambda: launches["sampler"](spec), 5)
        t_w, _ = cuda_ms(lambda: mk.sampler_probe(vt, samples, 99, spec, pairs), 5)
        t_p, _ = cuda_ms(lambda: mk.sampler_probe_reference(vt, samples, 99, spec, pairs), 1)
        sampler_ms, sampler_wrapper_ms = sampler_ms + t_k, sampler_wrapper_ms + t_w
        sampler_plain_ms += t_p
        emit({"phase": "sampler_probe", "spec": list(spec), "n": int(values.size),
              "pairs": pairs, "bit_exact": exact, "ms": t_k, "wrapper_ms": t_w, "plain_ms": t_p})
        gate("sampler_probe", exact, f"{spec}: the kernel's remaps differ from ops/rng.py")
        gate("sampler_probe", same_kernel, f"{spec}: the timed launch differs from the wrapper's")
    probes["sampler_probe"] = dict(launches=mk.LAUNCHES["sampler_probe"], ms=sampler_ms,
                                   wrapper_ms=sampler_wrapper_ms, plain_ms=sampler_plain_ms,
                                   max_abs_err=max(errs))

    # 4. goldens, through the public entry point with backend='cuda'
    base_cam = T.CameraSettings.make(**BASE_CAMERA)
    mesh_cam = T.CameraSettings.make(**MESH_CAMERA)
    ground = T.make_spheres([((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0)])

    lit = lit_scenes(T)
    cases = [
        ("base_normal_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=1, integrator="normal"), 0, 0.002, 1e-5),
        ("base_path_64x48.npy", T.base_scene(), base_cam,
         dict(width=64, height=48, spp=4, max_depth=8), 42, 0.005, 1e-4),
        ("one_weekend_48x27.npy", T.one_weekend_scene(0), T.CameraSettings.default(),
         dict(width=48, height=27, spp=2, max_depth=6), 3, 0.01, 2e-4),
        ("mesh_ico_48x36.npy", mesh_scene(T, 2), mesh_cam,
         dict(width=48, height=36, spp=2, max_depth=4), 11, 0.005, 1e-4),
        ("nee_light_48x36.npy", lit["nee"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=6, sky_intensity=0.0, nee=True,
              russian_roulette_depth=3), 9, 0.005, 1e-4),
        ("nee_mis_48x36.npy", lit["nee"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=6, sky_intensity=0.0, nee=True, mis=True,
              russian_roulette_depth=3), 9, 0.005, 1e-4),
        ("many_mis_48x36.npy", lit["many_lights"], base_cam,
         dict(width=48, height=36, spp=4, max_depth=4, sky_intensity=0.0, nee=True,
              mis=True), 17, 0.005, 1e-4),
        ("sobol_base_48x32.npy", T.base_scene(), base_cam,
         dict(width=48, height=32, spp=4, max_depth=6, sampler="sobol"), 5, 0.005, 1e-4),
    ]
    for golden, scene, cam, cfg_kw, seed, flip, mean in cases:
        cfg = T.RenderConfig(backend="cuda", **cfg_kw)
        img = T.render(scene, cam, cfg, frame_seed=seed)
        torch.cuda.synchronize()
        m = T.images_match(img, np.load(os.path.join(GOLDENS, golden)), flip, mean)
        emit({"phase": "goldens", "golden": golden, "flip_frac": m.flip_frac,
              "flip_limit": flip, "mean_abs": m.mean_abs, "mean_limit": mean,
              "max_abs": m.max_abs, "ok": m.ok})
        gate("goldens", m.ok, f"{golden}: {m}")
    # cornell_48x48 is chaotic across platforms (its glass sphere is a lens):
    # held to the plain version on this card at parity_check's contract.
    cfg = T.RenderConfig(width=48, height=48, spp=4, max_depth=6, sky_intensity=0.0,
                         nee=True, mis=True, backend="cuda")
    img = T.render(T.cornell_box_scene(), T.cornell_camera(), cfg, frame_seed=13)
    plain = mk.render_reference(T.cornell_box_scene().to(dev),
                                T.derive_camera(T.cornell_camera(), 48, 48).to(dev),
                                **render_kw(cfg, 13))
    m = T.images_match(img, plain, 0.015, 1e-3)
    g = T.images_match(img, np.load(os.path.join(GOLDENS, "cornell_48x48.npy")), 0.005, 1e-4)
    emit({"phase": "goldens", "golden": "cornell_48x48.npy", "against": "render_reference",
          "flip_frac": m.flip_frac, "flip_limit": 0.015, "mean_abs": m.mean_abs,
          "mean_limit": 1e-3, "max_abs": m.max_abs, "ok": m.ok,
          "vs_golden_flip_frac": g.flip_frac, "vs_golden_mean_abs": g.mean_abs})
    gate("goldens", m.ok, f"cornell_48x48 vs plain: {m}")

    # 5. kernel vs plain on the card, same inputs
    scene = T.one_weekend_scene(0, device=dev)
    w5, h5 = 320, 180
    cam5 = T.derive_camera(T.CameraSettings.default(), w5, h5).to(dev)
    kw5 = dict(width=w5, height=h5, spp=4, max_depth=30, t_min=1e-3, frame_seed=3)
    mk.render_cuda(scene, cam5, **kw5)
    mk.render_reference(scene, cam5, **kw5)
    plain5_a, plain = cuda_ms(lambda: mk.render_reference(scene, cam5, **kw5), 1)
    kernel5_ms, kern = cuda_ms(lambda: mk.render_cuda(scene, cam5, **kw5), 5)
    plain5_b, _ = cuda_ms(lambda: mk.render_reference(scene, cam5, **kw5), 1)
    m5 = T.images_match(kern, plain, 0.01, 2e-4)
    emit({"phase": "kernel_vs_plain", "size": [w5, h5], "spp": 4, "max_depth": 30,
          "flip_frac": m5.flip_frac, "mean_abs": m5.mean_abs, "max_abs": m5.max_abs,
          "kernel_ms": kernel5_ms, "plain_ms": (plain5_a + plain5_b) / 2,
          "card": smi, "ok": m5.ok})
    gate("kernel_vs_plain", m5.ok, str(m5))

    # 6. the main path at full size, through the public entry point
    w, h, spp = 1280, 720, 16
    cfg = T.RenderConfig(width=w, height=h, spp=spp, max_depth=30, backend="cuda")
    main_scene, main_cam = T.one_weekend_scene(0), T.CameraSettings.default()
    frame_ms, img, launches = time_main_path(T, mk, 5)
    main_img = img
    finite = bool(torch.isfinite(img).all())
    mean = float(img.mean())
    shape_ok = tuple(img.shape) == (h, w, 3)
    # The plain version of the same frame (its launches do not count).
    cam6 = T.derive_camera(main_cam, w, h).to(dev)
    plain_ms, plain_img, main_share = plain_run(lambda: mk.render_reference(
        main_scene.to(dev), cam6, width=w, height=h, spp=spp, max_depth=30,
        t_min=cfg.t_min, frame_seed=7))
    m6 = T.images_match(img, plain_img, 0.01, 2e-4)
    main_kernel = time_main_kernel(T, mk, 5)
    emit({"phase": "main_path", "size": [w, h], "spp": spp, "max_depth": 30,
          "shape": list(img.shape), "finite": finite, "mean": mean,
          "launches": launches, "ms_per_frame": frame_ms, **main_kernel,
          "primary_mrays_per_s": w * h * spp / (frame_ms * 1e3),
          "plain_ms": plain_ms, "plain_root_share": main_share,
          "vs_plain_flip_frac": m6.flip_frac,
          "vs_plain_mean_abs": m6.mean_abs, "vs_plain_max_abs": m6.max_abs,
          "card": smi})
    gate("main_path", shape_ok and finite and 0.0 < mean < 1.0,
         f"shape {tuple(img.shape)}, finite {finite}, mean {mean}")
    gate("main_path", launches == {"megakernel:brute+staged": 7},
         f"expected 7 staged brute-scan megakernel launches, counted {launches}")
    gate("main_path", m6.ok, f"vs plain: {m6}")

    # 7. the sphere BVH against the plain scan of the same spheres
    final = T.make_scene(T.one_weekend_scene(0, grid_min=-11, grid_max=11))
    gate("sphere_bvh", final.sphere_bvh is not None, "make_scene built no sphere BVH")
    final_dev = final.to(dev)
    brute_dev = dataclasses.replace(final_dev, sphere_bvh=None)
    w7, h7 = 320, 180
    cam7 = T.derive_camera(T.CameraSettings.default(), w7, h7).to(dev)
    kw7 = dict(width=w7, height=h7, spp=4, max_depth=50, t_min=1e-3, frame_seed=5)
    walk = against_plain(T, mk, lambda: mk.render_cuda(final_dev, cam7, **kw7),
                         final_dev, cam7, kw7, 0.02, 2e-3)
    brute = against_plain(T, mk, lambda: mk.render_cuda(brute_dev, cam7, **kw7),
                          final_dev, cam7, kw7, 0.01, 2e-4,
                          plain=(walk["plain_img"], walk["plain_ms"], walk["root_share"]))
    # Above the stage's STAGE_SPHERES the brute route scans the spheres from
    # device memory (render_kernel's global scan): 1,025 diffuse spheres of
    # distinct albedos, held to their own plain version at the brute arm's
    # contract.  (sphere_cloud's random metal and glass make 50 bounces
    # chaotic: 1.9-4.2% of pixels flip against the plain version, on the
    # sphere stage of 1,024 of them alike.)
    cloud = sphere_cloud(T, mk.STAGE_SPHERES + 1, "cpu", seed=7)
    cloud = dataclasses.replace(cloud, mat_kind=torch.full_like(cloud.mat_kind, T.LAMBERTIAN))
    cloud = T.make_scene(cloud, sphere_bvh=False).to(dev)
    wide = against_plain(T, mk, lambda: mk.render_cuda(cloud, cam7, **kw7), cloud, cam7, kw7,
                         0.01, 2e-4)
    m7, m7b, m7g = walk["match"], brute["match"], wide["match"]
    # The walk adds no flips over the scan: held to the brute kernel on the
    # same spheres at the standard contract.
    m7w = T.images_match(walk["img"], brute["img"], 0.01, 2e-4)
    emit({"phase": "sphere_bvh", "spheres": final.spheres.count,
          "bvh_nodes": final.sphere_bvh.num_nodes, "size": [w7, h7], "spp": 4,
          "max_depth": 50, "flip_frac": m7.flip_frac, "mean_abs": m7.mean_abs,
          "max_abs": m7.max_abs, "bvh_kernel_ms": walk["ms"], "brute_kernel_ms": brute["ms"],
          "plain_ms": walk["plain_ms"], "brute_vs_plain_flip_frac": m7b.flip_frac,
          "brute_vs_plain_mean_abs": m7b.mean_abs, "walk_vs_brute_flip_frac": m7w.flip_frac,
          "walk_vs_brute_mean_abs": m7w.mean_abs, "walk_vs_brute_max_abs": m7w.max_abs,
          "global_scan_spheres": cloud.spheres.count, "global_scan_kernel_ms": wide["ms"],
          "global_scan_plain_ms": wide["plain_ms"], "global_scan_vs_plain_flip_frac":
          m7g.flip_frac, "global_scan_vs_plain_mean_abs": m7g.mean_abs,
          "launches": {"walk": walk["launches"], "brute": brute["launches"],
                       "global_scan": wide["launches"]},
          "card": smi, "ok": m7.ok and m7w.ok and m7g.ok})
    gate("sphere_bvh", m7.ok, f"walk vs plain: {m7}")
    gate("sphere_bvh", m7w.ok, f"walk vs brute kernel: {m7w}")
    gate("sphere_bvh", walk["launches"] == {"megakernel:sphere_bvh+staged": 6},
         f"expected 6 staged sphere-BVH launches, counted {walk['launches']}")
    gate("sphere_bvh", brute["launches"] == {"megakernel:brute+staged": 6},
         f"expected 6 staged brute-scan launches, counted {brute['launches']}")
    gate("sphere_bvh", m7g.ok, f"global scan of {cloud.spheres.count} spheres vs plain: {m7g}")
    gate("sphere_bvh", wide["launches"] == {"megakernel:brute": 6},
         f"expected 6 global brute-scan launches, counted {wide['launches']}")

    # 8. the mesh kernel against the plain version
    ico4 = mesh_scene(T, 4).to(dev)
    w8, h8 = 320, 240
    cam8 = T.derive_camera(mesh_cam, w8, h8).to(dev)
    kw8 = dict(width=w8, height=h8, spp=2, max_depth=8, t_min=1e-3, frame_seed=8)
    r8 = against_plain(T, mk, lambda: mk.render_cuda(ico4, cam8, **kw8),
                       ico4, cam8, kw8, 0.01, 2e-4)
    m8 = r8["match"]
    emit({"phase": "mesh_vs_plain", "triangles": ico4.mesh.num_triangles,
          "bvh_nodes": ico4.bvh.num_nodes, "size": [w8, h8], "spp": 2, "max_depth": 8,
          "flip_frac": m8.flip_frac, "mean_abs": m8.mean_abs, "max_abs": m8.max_abs,
          "kernel_ms": r8["ms"], "plain_ms": r8["plain_ms"], "launches": r8["launches"],
          "card": smi, "ok": m8.ok})
    gate("mesh_vs_plain", m8.ok, str(m8))
    gate("mesh_vs_plain", r8["launches"] == {"megakernel:mesh_bvh": 6},
         f"expected 6 mesh-BVH launches, counted {r8['launches']}")

    # 9-10. BASELINE configs 3 and 4 at full size, and config 1 (the normal
    # AOV through render_aov_kernel), through the public entry point (2
    # warm-up and 5 timed frames), each gated against the plain version of
    # the same frame.
    paths = {}
    for phase, route, scene, cam, cfg, seed, flip, mean_tol in (
        ("config1", "brute", T.as_scene(T.base_scene()), base_cam,
         T.RenderConfig(width=800, height=600, spp=1, integrator="normal", backend="cuda"), 1,
         0.01, 2e-4),
        ("config3", "sphere_bvh+staged", final, T.CameraSettings.default(),
         T.RenderConfig(width=1280, height=720, spp=1, max_depth=50, backend="cuda"), 3,
         0.02, 2e-3),
        ("config4", "mesh_bvh", mesh_scene(T, 6), mesh_cam,
         T.RenderConfig(width=640, height=480, spp=1, max_depth=8, backend="cuda"), 4,
         0.01, 2e-4),
    ):
        kw = dict(width=cfg.width, height=cfg.height, spp=cfg.spp, max_depth=cfg.max_depth,
                  t_min=cfg.t_min, frame_seed=seed)
        if cfg.integrator != "path":
            kw["mode"] = cfg.integrator
        inputs = (scene.to(dev), T.derive_camera(cam, cfg.width, cfg.height).to(dev), kw)
        r = against_plain(T, mk, lambda: T.render(scene, cam, cfg, frame_seed=seed), *inputs,
                          flip, mean_tol, warmup=2, walks=phase != "config1")
        m = r["match"]
        # The kernel alone, as phases 12-13 time it: render() of these short
        # frames is host-bound.
        k_ms = kernel_ms(mk, *inputs, 5)
        paths[phase] = dict(r, route=route, kernel_ms=k_ms, inputs=inputs)
        emit({"phase": phase, "size": [cfg.width, cfg.height], "spp": cfg.spp,
              "max_depth": cfg.max_depth, "spheres": scene.spheres.count,
              "triangles": 0 if scene.mesh is None else scene.mesh.num_triangles,
              "finite": r["finite"], "mean": r["mean"], "launches": r["launches"],
              "ms_per_frame": r["ms"], "kernel_ms": k_ms,
              "primary_mrays_per_s": cfg.width * cfg.height * cfg.spp / (r["ms"] * 1e3),
              "plain_ms": r["plain_ms"], "vs_plain_flip_frac": m.flip_frac,
              "vs_plain_mean_abs": m.mean_abs, "vs_plain_max_abs": m.max_abs,
              "vs_plain_limits": [flip, mean_tol], "card": smi, "ok": m.ok})
        gate(phase, r["finite"] and 0.0 < r["mean"] < 1.0,
             f"finite {r['finite']}, mean {r['mean']}")
        gate(phase, r["launches"] == {"megakernel:" + route: 7},
             f"expected 7 {route} megakernel launches, counted {r['launches']}")
        gate(phase, m.ok, f"vs plain: {m}")

    # 11. the NEE kernel against its plain version, each case on its own key
    nee_runs = {}
    for case, route, scene, cam_kw, cfg in (
        ("nee", "brute+nee+staged", lit["nee"], BASE_CAMERA,
         T.RenderConfig(width=320, height=240, spp=4, max_depth=8, sky_intensity=0.0,
                        nee=True, mis=True, russian_roulette_depth=3)),
        ("many_lights", "mesh_bvh+nee+staged", lit["many_lights"], BASE_CAMERA,
         T.RenderConfig(width=320, height=240, spp=4, max_depth=4, sky_intensity=0.0,
                        nee=True, mis=True)),
        ("night", "brute+nee+staged", lit["night"], NIGHT_CAMERA,
         T.RenderConfig(width=320, height=180, spp=4, max_depth=30, nee=True, mis=True)),
    ):
        sc = scene.to(dev)
        cam = T.derive_camera(T.CameraSettings.make(**cam_kw), cfg.width, cfg.height).to(dev)
        kw = render_kw(cfg, 3)
        r = against_plain(T, mk, lambda: mk.render_cuda(sc, cam, **kw), sc, cam, kw,
                          0.01, 2e-4)
        m = r["match"]
        k_ms = kernel_ms(mk, sc, cam, kw, 5)
        nee_runs[case] = dict(r, route=route, kernel_ms=k_ms, inputs=(sc, cam, kw))
        emit({"phase": "nee_vs_plain", "case": case, "size": [cfg.width, cfg.height],
              "spp": cfg.spp, "max_depth": cfg.max_depth, "lights": [
                  0 if sc.lights is None else sc.lights.count,
                  0 if sc.tri_lights is None else sc.tri_lights.count],
              "flip_frac": m.flip_frac, "mean_abs": m.mean_abs, "max_abs": m.max_abs,
              "ms": r["ms"], "kernel_ms": k_ms, "plain_ms": r["plain_ms"],
              "launches": r["launches"],
              "card": smi, "ok": m.ok})
        gate("nee_vs_plain", m.ok, f"{case}: {m}")
        gate("nee_vs_plain", r["launches"] == {"megakernel:" + route: 6},
             f"{case}: expected 6 {route} launches, counted {r['launches']}")

    # 12-13. the lit path and the samplers at full frame size, through the
    # public entry point, each held to the plain version of the same frame.
    for phase, route, scene, cam, cfg, seed, flip, mean_tol in (
        ("lit_path", "mesh_bvh+nee+staged", T.cornell_box_scene(), T.cornell_camera(),
         T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, sky_intensity=0.0,
                        nee=True, mis=True, backend="cuda"), 0, 0.015, 1e-3),
        ("sampler_path", "brute+sobol+staged", T.one_weekend_scene(0),
         T.CameraSettings.default(),
         T.RenderConfig(width=1280, height=720, spp=16, max_depth=30, sampler="sobol",
                        backend="cuda"), 7, 0.01, 2e-4),
        ("sampler_path", "brute+stratified+staged", T.one_weekend_scene(0),
         T.CameraSettings.default(),
         T.RenderConfig(width=320, height=180, spp=16, max_depth=30, sampler="stratified",
                        backend="cuda"), 7, 0.01, 2e-4),
    ):
        sc_dev = scene.to(dev)
        cam_dev = T.derive_camera(cam, cfg.width, cfg.height).to(dev)
        kw = render_kw(cfg, seed)
        r = against_plain(T, mk, lambda: T.render(scene, cam, cfg, frame_seed=seed), sc_dev,
                          cam_dev, kw, flip, mean_tol, warmup=2, walks=phase == "lit_path")
        # The kernel alone, scene and camera already on the card: short
        # frames are host-bound in render() (PERF.md section 5).
        k_ms = kernel_ms(mk, sc_dev, cam_dev, kw, 5)
        m = r["match"]
        paths[route] = dict(r, route=route, kernel_ms=k_ms, inputs=(sc_dev, cam_dev, kw))
        emit({"phase": phase, "route": route, "size": [cfg.width, cfg.height],
              "spp": cfg.spp, "max_depth": cfg.max_depth, "sampler": cfg.sampler,
              "nee": cfg.nee, "mis": cfg.mis, "finite": r["finite"], "mean": r["mean"],
              "launches": r["launches"], "ms_per_frame": r["ms"], "kernel_ms": k_ms,
              "primary_mrays_per_s": cfg.width * cfg.height * cfg.spp / (r["ms"] * 1e3),
              "plain_ms": r["plain_ms"], "vs_plain_flip_frac": m.flip_frac,
              "vs_plain_mean_abs": m.mean_abs, "vs_plain_max_abs": m.max_abs,
              "vs_plain_limits": [flip, mean_tol], "card": smi, "ok": m.ok})
        gate(phase, r["finite"] and 0.0 < r["mean"] < 1.0,
             f"{route}: finite {r['finite']}, mean {r['mean']}")
        gate(phase, r["launches"] == {"megakernel:" + route: 7},
             f"expected 7 {route} megakernel launches, counted {r['launches']}")
        gate(phase, m.ok, f"{route} vs plain: {m}")

    # 14. the BVH builder that ran: the native one, as in the CPU tests
    from gpu_ray_tracing_tpu_torch.ops import bvh as bvh_ops
    builds = dict(bvh_ops.BUILDS)
    emit({"phase": "bvh_builds", "builds": builds})
    gate("bvh_builds", builds.get("native", 0) > 0 and builds.get("numpy", 0) == 0,
         f"expected only native BVH builds, got {builds}")

    # 15. the adaptive kernel (K1f) against its plain version
    adaptive_runs = {}
    # Each image is held to 1% / 2e-4, the chaotic Cornell box at the flip
    # of its contract in phase 12 (1.5%: a pixel flips when any of its
    # samples does).  The Cornell box is noisy enough that at tol 0.03 every
    # tile takes the budget; at 0.5 its three tiles stop at three counts.
    for case, route, scene, cam_s, w, h, tol, extra, flip in (
        ("one_weekend", "brute+adaptive", T.one_weekend_scene(0), T.CameraSettings.default(),
         320, 180, 0.03, {}, 0.01),
        ("cornell", "mesh_bvh+nee+adaptive", T.cornell_box_scene(), T.cornell_camera(), 128, 96,
         0.5, dict(nee=True, mis=True, sky_intensity=0.0), 0.015),
    ):
        sc = scene.to(dev)
        cam = T.derive_camera(cam_s, w, h).to(dev)
        kw = dict(width=w, height=h, spp=32, max_depth=8, t_min=1e-3, frame_seed=3,
                  adaptive_tol=tol, adaptive_min_spp=4, return_spp_map=True, **extra)
        mk.LAUNCHES.clear()
        mk.render_cuda(sc, cam, **kw)
        k_ms, (img, smap) = cuda_ms(lambda: mk.render_cuda(sc, cam, **kw), 5)
        ad_l = dict(mk.LAUNCHES)
        p_ms, (pimg, pmap), p_share = plain_run(lambda: mk.render_reference(sc, cam, **kw))
        tiles_differ, mm = adaptive_match(T, img, smap, pimg, pmap, flip, 2e-4)
        early = bool(smap.min() < smap.max())
        rays = mk.render_cuda(sc, cam, **{**kw, "return_spp_map": False},
                              return_ray_count=True)[1]
        # Bytes: the image and spp map written, the six state planes read
        # and written.
        adaptive_runs[case] = dict(route=route, launches=ad_l, ms=k_ms, plain_ms=p_ms,
                                   match=mm, scene=sc, rays=float(rays.double().sum()),
                                   root_share=p_share,
                                   out_bytes=(3 + 1 + 2 * 6) * 4 * w * h,
                                   cluster=mk.adaptive_cluster())
        emit({"phase": "adaptive_vs_plain", "case": case, "route": route, "size": [w, h],
              "budget": 32, "max_depth": 8, "tol": tol, "min_spp": 4,
              "tiles": int(smap[::32, ::128].numel()), "tiles_differ": tiles_differ,
              "tile_spp": smap[::32, ::128].flatten().tolist(),
              "spp_mean": float(smap.mean()), "spp_min": float(smap.min()),
              "spp_max": float(smap.max()), "flip_frac": mm.flip_frac,
              "mean_abs": mm.mean_abs, "max_abs": mm.max_abs, "limits": [flip, 2e-4],
              "kernel_ms": k_ms, "cluster_blocks": adaptive_runs[case]["cluster"],
              "plain_ms": p_ms, "launches": ad_l, "card": smi,
              "ok": mm.ok and tiles_differ <= 1 and early})
        gate("adaptive_vs_plain", tiles_differ <= 1, f"{case}: {tiles_differ} tiles differ")
        gate("adaptive_vs_plain", mm.ok, f"{case}: {mm}")
        gate("adaptive_vs_plain", early, f"{case}: no tile stopped before the budget")
        gate("adaptive_vs_plain", ad_l == {"megakernel:" + route: 6},
             f"{case}: expected 6 {route} launches, counted {ad_l}")

    # 16. adaptive resume at the main path's size, bit for bit
    ad_cfg = T.RenderConfig(width=1280, height=720, spp=32, max_depth=30, adaptive_tol=0.03,
                            adaptive_min_spp=8)
    one = T.render(main_scene, main_cam, ad_cfg, frame_seed=7)
    st = T.init_adaptive_accum(720, 1280, device=dev)
    for _ in range(4):
        st = T.adaptive_progressive_step(st, main_scene, main_cam, ad_cfg, frame_seed=7,
                                         spp_per_step=8)
    resume_exact = bool(torch.equal(st.image, one))
    st5 = T.adaptive_progressive_step(st, main_scene, main_cam, ad_cfg, frame_seed=7,
                                      spp_per_step=8)
    fifth_noop = bool(torch.equal(st5.count, st.count) and torch.equal(st5.image, one))
    wide = T.render(main_scene, main_cam, dataclasses.replace(
        ad_cfg, adaptive_tol=1e6, adaptive_min_spp=4), frame_seed=7)
    fixed4 = T.render(main_scene, main_cam, dataclasses.replace(ad_cfg, spp=4, adaptive_tol=0.0),
                      frame_seed=7)
    prefix_exact = bool(torch.equal(wide, fixed4))
    emit({"phase": "adaptive_resume", "size": [1280, 720], "budget": 32, "max_depth": 30,
          "tol": 0.03, "min_spp": 8, "resume_equals_one_shot": resume_exact,
          "fifth_step_noop": fifth_noop, "prefix_equals_fixed_spp4": prefix_exact,
          "spp_min": float(st.count.min()), "spp_max": float(st.count.max()),
          "finite": bool(torch.isfinite(one).all())})
    gate("adaptive_resume", resume_exact, "4 chunked steps differ from the one-shot render")
    gate("adaptive_resume", fifth_noop, "a fifth step changed the state")
    gate("adaptive_resume", prefix_exact, "tol 1e6 / min 4 differs from the fixed spp=4 frame")

    # 17. the adaptive main path, timed beside the fixed 32-spp frame
    fixed32 = dataclasses.replace(ad_cfg, adaptive_tol=0.0)
    mk.LAUNCHES.clear()
    for _ in range(2):
        T.render(main_scene, main_cam, ad_cfg, frame_seed=7)
    ad_ms, ad_img = cuda_ms(lambda: T.render(main_scene, main_cam, ad_cfg, frame_seed=7), 5)
    ad_launches = dict(mk.LAUNCHES)
    ad_cluster = mk.adaptive_cluster()
    T.render(main_scene, main_cam, fixed32, frame_seed=7)
    fx_ms, fx_img = cuda_ms(lambda: T.render(main_scene, main_cam, fixed32, frame_seed=7), 5)
    main_dev = main_scene.to(dev)
    ad_kw = dict(width=1280, height=720, spp=32, max_depth=30, t_min=ad_cfg.t_min, frame_seed=7,
                 adaptive_tol=0.03, adaptive_min_spp=8, return_spp_map=True)
    k_img, smap = mk.render_cuda(main_dev, cam6, **ad_kw)
    # The plain version of the same frame (its launches do not count).
    ad_plain_ms, (p_img, p_map), ad_share = plain_run(
        lambda: mk.render_reference(main_dev, cam6, **ad_kw))
    ad_tiles_differ, m17 = adaptive_match(T, k_img, smap, p_img, p_map, 0.01, 2e-4)
    ad_rays = T.count_traced_rays(main_scene, main_cam, ad_cfg, frame_seed=7)["rays_traced"]
    spp_mean = float(smap.mean())
    rel = float((ad_img - fx_img).abs().mean() / fx_img.mean())
    emit({"phase": "adaptive_path", "size": [1280, 720], "budget": 32, "max_depth": 30,
          "tol": 0.03, "min_spp": 8, "ms_per_frame": ad_ms, "spp_mean": spp_mean,
          "spp_min": float(smap.min()), "spp_max": float(smap.max()),
          "ms_per_sample_taken": ad_ms / spp_mean, "fixed32_ms_per_frame": fx_ms,
          "fixed32_ms_per_sample": fx_ms / 32, "rays_traced": ad_rays,
          "rel_mean_diff_vs_fixed32": rel, "launches": ad_launches,
          "finite": bool(torch.isfinite(ad_img).all()), "render_equals_render_cuda":
          bool(torch.equal(ad_img, k_img)), "plain_ms": ad_plain_ms,
          "vs_plain_tiles": int(smap[::32, ::128].numel()),
          "vs_plain_tiles_differ": ad_tiles_differ, "vs_plain_flip_frac": m17.flip_frac,
          "vs_plain_mean_abs": m17.mean_abs, "vs_plain_max_abs": m17.max_abs,
          "vs_plain_limits": [0.01, 2e-4], "cluster_blocks": ad_cluster, "card": smi})
    gate("adaptive_path", ad_launches == {"megakernel:brute+adaptive": 7},
         f"expected 7 brute+adaptive launches, counted {ad_launches}")
    gate("adaptive_path", bool(torch.isfinite(ad_img).all()), "the adaptive frame is not finite")
    gate("adaptive_path", bool(torch.equal(ad_img, k_img)), "render() differs from render_cuda")
    gate("adaptive_path", ad_tiles_differ <= 1, f"{ad_tiles_differ} tiles differ from plain")
    gate("adaptive_path", m17.ok, f"vs plain: {m17}")
    # The adaptive frames' kernel alone by blocks a tile (every size renders
    # the same bits; 0 is the launcher's choice).
    sweep = {}
    for blocks in (0, 1, 2, 4, 8, 16):
        mk.adaptive_cluster(blocks)
        sweep[blocks] = {name: kernel_ms(mk, sc, cam, kw, 3)
                         for name, (sc, cam, kw) in adaptive_frames(T).items()}
        sweep[blocks]["blocks_used"] = mk.adaptive_cluster()
    mk.adaptive_cluster(0)
    emit({"phase": "adaptive_clusters", "kernel_ms_by_blocks_a_tile": sweep, "card": smi})

    # 18. the reference's own loop: 16 progressive steps at the main size,
    # as a user calls it (scene on the host, camera settings), and again
    # with the scene on the card and the camera derived once
    prog_cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30)
    state = T.init_accum(720, 1280)
    T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7)  # warm-up
    torch.cuda.synchronize()
    mk.LAUNCHES.clear()
    t0 = time.perf_counter()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(16):
        state = T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7)
    ev1.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / 16
    step_ms = ev0.elapsed_time(ev1) / 16
    prog_launches = dict(mk.LAUNCHES)
    resident = T.init_accum(720, 1280)
    ev0.record()
    for _ in range(16):
        resident = T.progressive_step(resident, main_dev, cam6, prog_cfg, frame_seed=7)
    ev1.record()
    torch.cuda.synchronize()
    resident_ms = ev0.elapsed_time(ev1) / 16
    batch16 = T.render(main_scene, main_cam, prog_cfg, frame_seed=7)
    prog_err = float((state.rgb - batch16).abs().max())
    reset = T.progressive_step(state, main_scene, main_cam, prog_cfg, frame_seed=7, reset=True)
    two = T.init_accum(720, 1280)
    for _ in range(2):
        two = T.progressive_step(two, main_scene, main_cam, prog_cfg, frame_seed=7,
                                 spp_per_step=8)
    two_err = float((two.rgb - state.rgb).abs().max())
    emit({"phase": "progressive_path", "size": [1280, 720], "steps": 16, "max_depth": 30,
          "ms_per_step": step_ms, "host_ms_per_step": host_ms,
          "ms_per_step_scene_on_card": resident_ms, "count": int(state.count),
          "max_abs_vs_render_spp16": prog_err, "reset_count": int(reset.count),
          "two_steps_of_8_max_abs": two_err, "launches": prog_launches, "card": smi})
    gate("progressive_path", prog_err <= 1e-5, f"16 steps vs render(spp=16): {prog_err}")
    gate("progressive_path", prog_launches == {"megakernel:brute+staged": 16},
         f"expected 16 staged brute launches, counted {prog_launches}")
    gate("progressive_path", int(state.count) == 16 and int(reset.count) == 1,
         f"count {int(state.count)}, after reset {int(reset.count)}")
    gate("progressive_path", two_err <= 2e-5, f"2 steps of 8 vs 16 of 1: {two_err}")
    gate("progressive_path", bool(torch.equal(resident.rgb, state.rgb)),
         "the card-resident steps differ from the host-scene steps")

    # 19. ray counters: exact against the plain version, the analytic cases,
    # and the main path's rays with the counter on and off
    diffuse = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.7, 0.7, 0.7), 0.0),
        ((-0.6, 0.35, -2.2), 0.35, T.LAMBERTIAN, (0.8, 0.3, 0.3), 0.0)]))
    cnt_cfg = T.RenderConfig(width=48, height=32, spp=4, max_depth=3)
    got = T.count_traced_rays(diffuse, base_cam, cnt_cfg, frame_seed=7, return_map=True)
    _, want = mk.render_reference(diffuse.to(dev), T.derive_camera(base_cam, 48, 32).to(dev),
                                  width=48, height=32, spp=4, max_depth=3, t_min=1e-3,
                                  frame_seed=7, return_ray_count=True)
    counters_exact = bool(torch.equal(got["map"], want))
    up = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 10.0, 0.0], [0.0, 0.0, 1.0], 20.0, 0.0,
                               10.0)
    down = T.CameraSettings.make([0.0, 2.0, 0.0], [0.0, 0.0, 0.0], [0.0, 0.0, 1.0], 40.0, 0.0,
                                 10.0)
    lit_ground = T.make_scene(T.make_spheres([
        ((0, -1000.0, 0), 1000.0, T.LAMBERTIAN, (0.5, 0.5, 0.5), 0.0),
        ((0.0, 50.0, 0.0), 5.0, T.EMISSIVE, (1.0, 1.0, 1.0), 4.0)]))
    analytic = []
    for sc, c, per, extra in ((ground, up, 1, dict(max_depth=6)),
                              (ground, down, 2, dict(max_depth=2)),
                              (lit_ground, down, 3, dict(max_depth=2, nee=True,
                                                         sky_intensity=0.0))):
        r = T.count_traced_rays(sc, c, T.RenderConfig(width=48, height=32, spp=4, **extra),
                                frame_seed=3)
        analytic.append(r["rays_traced"] == per * r["primary_rays"])
    kw_main = dict(width=1280, height=720, spp=16, max_depth=30, t_min=1e-3, frame_seed=7)
    main_cfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30)
    main_rays = T.count_traced_rays(main_scene, main_cam, main_cfg, frame_seed=7)["rays_traced"]
    off_a, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, **kw_main), 3)
    on_a, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, return_ray_count=True, **kw_main), 3)
    on_b, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, return_ray_count=True, **kw_main), 3)
    off_b, _ = cuda_ms(lambda: mk.render_cuda(main_dev, cam6, **kw_main), 3)
    off_ms, on_ms = (off_a + off_b) / 2, (on_a + on_b) / 2
    emit({"phase": "ray_count", "diffuse_exact_vs_plain": counters_exact,
          "analytic_exact": analytic, "main_path_rays_traced": main_rays,
          "main_path_primary_rays": 1280 * 720 * 16, "kernel_ms_counter_off": [off_a, off_b],
          "kernel_ms_counter_on": [on_a, on_b], "counter_cost": on_ms / off_ms - 1.0,
          "bounce_mrays_per_s": main_rays / (off_ms * 1e3), "card": smi})
    gate("ray_count", counters_exact, "the kernel's counters differ from the plain version's")
    gate("ray_count", all(analytic), f"analytic cases: {analytic}")

    # 20. the wavefront kernels (K2) against their plain versions
    cam20 = T.derive_camera(main_cam, 320, 180).to(dev)
    nee_cfg = T.RenderConfig(width=320, height=240, spp=4, max_depth=8, sky_intensity=0.0,
                             nee=True, mis=True, russian_roulette_depth=3)
    nee_cam = T.derive_camera(base_cam, 320, 240).to(dev)
    for case, sc, cam, w, h, regen, eng_kw in (
        ("one_weekend", main_dev, cam20, 320, 180, False, {}),
        ("nee_mis", lit["nee"].to(dev), nee_cam, 320, 240, False,
         dict(nee=True, mis=True, sky_intensity=0.0, russian_roulette_depth=3)),
        ("one_weekend_per_ray", main_dev, cam20, 320, 180, True, {}),
        ("nee_mis_per_ray", lit["nee"].to(dev), nee_cam, 320, 240, True,
         dict(nee=True, mis=True, sky_intensity=0.0, russian_roulette_depth=3)),
    ):
        mk.LAUNCHES.clear()
        r = bounce_vs_plain(wf, sc, cam, w, h, regen=regen, **eng_kw)
        emit({"phase": "wavefront_vs_plain", "case": case, "size": [w, h], "per_ray": regen,
              "launches": dict(mk.LAUNCHES), "limits": [0.01, 2e-4], **r})
        gate("wavefront_vs_plain", r["ok"], f"{case}: {r}")
        gate("wavefront_vs_plain", sum(v for k, v in mk.LAUNCHES.items()
                                       if k.startswith("wavefront:")) == 6,
             f"{case}: expected 6 bounce launches, counted {dict(mk.LAUNCHES)}")
    # The device loop's partition, refill and step against their plain
    # versions on a real state, every sort, with and without regeneration.
    part_rows = partition_vs_plain(wf, main_dev, cam20, 320, 180)
    emit({"phase": "wavefront_vs_plain", "case": "partition_refill_step", "size": [320, 180],
          "rows": part_rows, "limits": {"perm_planes_ids_counts": "exact",
                                        "filled_refilled_rays_max_abs": 1e-5}})
    for r in part_rows:
        gate("wavefront_vs_plain", r["ok"], f"partition/refill vs plain: {r}")
    kw20 = dict(width=320, height=180, spp=4, max_depth=30, t_min=1e-3, frame_seed=3)
    for regen in (False, True):
        wf.render_wavefront(main_dev, cam20, regenerate=regen, **kw20)
        k_ms, k_img = cuda_ms(lambda: wf.render_wavefront(main_dev, cam20, regenerate=regen,
                                                          **kw20), 3)
        p_ms, p_img = cuda_ms(lambda: wf.render_wavefront_reference(
            main_dev, cam20, regenerate=regen, **kw20), 1)
        m = T.images_match(k_img, p_img, 0.01, 2e-4)
        emit({"phase": "wavefront_vs_plain", "case": "engine", "regenerate": regen,
              "size": [320, 180], "spp": 4, "max_depth": 30, "flip_frac": m.flip_frac,
              "mean_abs": m.mean_abs, "max_abs": m.max_abs, "kernel_ms": k_ms,
              "plain_ms": p_ms, "card": smi, "ok": m.ok})
        gate("wavefront_vs_plain", m.ok, f"engine, regenerate {regen}: {m}")

    # 21. the main frame through backend='wavefront', regenerate off and on
    wave = {}
    for mode in ("off", "on"):
        wcfg = T.RenderConfig(width=1280, height=720, spp=16, max_depth=30,
                              backend="wavefront", regenerate=mode)
        run = lambda: T.render(main_scene, main_cam, wcfg, frame_seed=7)
        for _ in range(2):
            run()
        mk.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        w_ms, w_img = cuda_ms(run, 5)
        host_ms = (time.perf_counter() - t0) * 1e3 / 5
        w_launches, stats = dict(mk.LAUNCHES), dict(wf.LAST_RUN)
        again = run()
        busy = device_breakdown(run)
        calls = partition_calls(wf, run)
        p_ms, p_img = cuda_ms(lambda: wf.render_wavefront_reference(
            main_dev, cam6, regenerate=mode == "on", **kw_main), 1)
        route = "wavefront:brute" + ("+regen" if mode == "on" else "")
        live = stats.pop("live_per_iteration")
        m21 = T.images_match(w_img, p_img, 0.01, 2e-4)
        wave[mode] = dict(ms=w_ms, img=w_img, launches=w_launches, plain_ms=p_ms, route=route,
                          max_abs=m21.max_abs, stats=stats, busy=busy, calls=calls)
        vs_mega = float((w_img - main_img).abs().max())
        iterations = stats["bounce_launches"]
        read_bound = 1 if mode == "off" else -(-iterations // wf.POLL_EVERY) + 1
        emit({"phase": "wavefront_path", "regenerate": mode, "size": [1280, 720], "spp": 16,
              "max_depth": 30, "ms_per_frame": w_ms, "host_ms_per_frame": host_ms,
              "megakernel_ms_per_frame": frame_ms, "max_abs_vs_megakernel": vs_mega,
              "bit_equal_to_megakernel": bool(torch.equal(w_img, main_img)),
              "max_abs_between_two_runs": float((again - w_img).abs().max()),
              "finite": bool(torch.isfinite(w_img).all()), "launches": w_launches,
              "per_frame": stats, "host_reads_per_frame": stats["host_syncs"],
              "host_reads_bound": read_bound, "live_rays_per_iteration": live,
              "live_share_per_iteration": [v / (1280 * 720 * (16 if mode == "off" else 1))
                                           for v in live],
              **busy, "partition_calls": calls,
              "plain_ms": p_ms, "vs_plain": {"flip_frac": m21.flip_frac,
                                              "mean_abs": m21.mean_abs,
                                              "max_abs": m21.max_abs, "limits": [0.01, 2e-4]},
              "card": smi})
        gate("wavefront_path", bool(torch.isfinite(w_img).all()), f"{mode}: not finite")
        gate("wavefront_path", m21.ok, f"{mode}: against the plain engine's frame: {m21}")
        # The launches counted in the 5 timed frames against the schedule
        # the host must enqueue: without regeneration max_depth bounces and
        # steps and max_depth - 1 partitions a sample batch, and one fill;
        # with it POLL_EVERY iterations a poll up to the poll that reads the
        # flag of the group in which the device counted its last iteration
        # (one group behind), each a bounce, partition, refill and step,
        # and one fill.  A missed or doubled launch breaks the count.
        if mode == "off":
            batches = -(-16 // stats["sample_batch"])
            want = dict(bounce=30 * batches, raygen=batches, partition=29 * batches,
                        advance=30 * batches)
        else:
            its = wf.POLL_EVERY * (-(-iterations // wf.POLL_EVERY) + 1)
            want = dict(bounce=its, raygen=1 + its, partition=its, advance=its)
        gate("wavefront_path", w_launches == {
            route: 5 * want["bounce"], "wavefront_raygen": 5 * want["raygen"],
            "wavefront_partition": 5 * want["partition"],
            "wavefront_advance": 5 * want["advance"]}
             and stats["enqueued"] == want and 0 < iterations <= want["bounce"],
             f"{mode}: the schedule is {want} a frame, the device counted {iterations} "
             f"iterations, 5 frames counted {w_launches}")
        gate("wavefront_path", calls["count"] == calls["segments"] == want["partition"],
             f"{mode}: {calls['count']} partition calls and {calls['segments']} runs of "
             f"partition kernels in the profiled frame, the schedule is {want['partition']}")
        gate("wavefront_path", stats["host_syncs"] <= read_bound,
             f"{mode}: {stats['host_syncs']} host reads a frame, bound {read_bound}")
        gate("wavefront_path", stats["sphere_scan"] == "staged",
             f"{mode}: the bounce kernel scanned by {stats['sphere_scan']}, not the stage")
        gate("wavefront_path", stats["live_ray_bounces"] == main_rays,
             f"{mode}: {stats['live_ray_bounces']} live ray-bounces, the megakernel traced "
             f"{main_rays} rays")
        gate("wavefront_path", float((again - w_img).abs().max()) == 0.0,
             f"{mode}: two runs differ")
        if mode == "off":
            gate("wavefront_path", bool(torch.equal(w_img, main_img)),
                 f"regenerate off differs from the megakernel's frame by {vs_mega}")
        else:
            gate("wavefront_path", vs_mega <= 3e-5,
                 f"regenerate on differs from the megakernel's frame by {vs_mega}")
    # The device loop's kernels at the main path's shape, timed for the
    # kernels line and held to their plain versions there: the 16 samples'
    # 14,745,600-slot array and the 921,600-slot pool, every sort.
    wf_parts = time_partition(wf, main_dev, cam6, 1280, 720, 16)
    main_part = partition_vs_plain(wf, main_dev, cam6, 1280, 720, 16)
    emit({"phase": "wavefront_path", "loop_kernels_at_main_shape": wf_parts,
          "vs_plain_at_main_shape": main_part,
          "limits": {"perm_planes_ids_counts": "exact", "filled_refilled_rays_max_abs": 1e-5},
          "card": smi})
    gate("wavefront_path", wf_parts["match"]["ok"],
         f"timed fill/partition vs plain at the main shape: {wf_parts['match']}")
    part = wf_parts["partition"]
    gate("wavefront_path", part["library_perm_equal"] and part["pool_library_perm_equal"]
         and part["pool_compact"],
         f"the partition differs from torch.sort(keys, stable=True) at the main shape: {part}")
    for r in main_part:
        gate("wavefront_path", r["ok"], f"partition/refill vs plain at the main shape: {r}")
    # Scheduling choices, timed on the same frame (the image does not
    # change): three runs each of the sort keys, the compaction threshold
    # and the sample batch (its slots, wf.SAMPLE_SLOTS, set for the call),
    # both modes.
    variants = {}
    options = [("sort", v) for v in wf.SORTS] + [
        ("compact_threshold", v) for v in (0.5, 0.25, 0.0)]
    for regen in (False, True):
        extras = [dict([o]) for o in options] + ([] if regen else [
            dict(sample_batch=1), dict(sample_batch=4)])
        for extra in extras:
            label = ("on," if regen else "off,") + ",".join(f"{k}={v}" for k, v in extra.items())
            kw_v = {k: v for k, v in extra.items() if k != "sample_batch"}
            slots = extra.get("sample_batch", 0) * 1280 * 720 or wf.SAMPLE_SLOTS

            def call():
                default, wf.SAMPLE_SLOTS = wf.SAMPLE_SLOTS, slots
                try:
                    return wf.render_wavefront(main_dev, cam6, regenerate=regen, **kw_main,
                                               **kw_v)
                finally:
                    wf.SAMPLE_SLOTS = default
            call()
            runs = [cuda_ms(call, 3) for _ in range(3)]
            v_img = runs[0][1]
            variants[label] = dict(ms=[r[0] for r in runs],
                                   sample_batch=wf.LAST_RUN["sample_batch"],
                                   host_syncs=wf.LAST_RUN["host_syncs"],
                                   bounce_launches=wf.LAST_RUN["bounce_launches"],
                                   compactions=wf.LAST_RUN["compactions"],
                                   equal=bool(torch.equal(v_img, main_img)) if not regen
                                   else float((v_img - main_img).abs().max()) <= 3e-5)
    # The sort on a BVH route: config 3's frame (a sphere BVH, depth 50).
    sc3, cam3, kw3 = paths["config3"]["inputs"]
    for label, extra in (("config3,off,sort=octant", {}), ("config3,off,sort=live",
                                                           dict(sort="live"))):
        ref3 = mk.render_cuda(sc3, cam3, **kw3)
        wf.render_wavefront(sc3, cam3, **kw3, **extra)
        v_ms, v_img = cuda_ms(lambda: wf.render_wavefront(sc3, cam3, **kw3, **extra), 3)
        variants[label] = dict(ms=[v_ms], host_syncs=wf.LAST_RUN["host_syncs"],
                               bounce_launches=wf.LAST_RUN["bounce_launches"],
                               compactions=wf.LAST_RUN["compactions"],
                               equal=bool(torch.equal(v_img, ref3)))
    emit({"phase": "wavefront_path", "scheduling": variants, "card": smi})
    gate("wavefront_path", all(v["equal"] for v in variants.values()),
         f"a scheduling option changed the image: {variants}")
    # The other routes at small sizes, each bit-equal to render_cuda.
    lit_kw = dict(nee=True, mis=True, sky_intensity=0.0)
    small = {}
    mk.LAUNCHES.clear()
    for case, sc, cam_s, w, h, kw in (
        ("sphere_bvh", final, main_cam, 320, 180, dict(spp=2, max_depth=50)),
        ("icosphere4", mesh_scene(T, 4), mesh_cam, 320, 240, dict(spp=2, max_depth=8)),
        ("cornell_nee_mis", T.cornell_box_scene(), T.cornell_camera(), 128, 96,
         dict(spp=4, max_depth=8, **lit_kw)),
        ("many_lights", lit["many_lights"], base_cam, 320, 240,
         dict(spp=4, max_depth=4, **lit_kw)),
        ("sobol", main_scene, main_cam, 160, 90, dict(spp=4, max_depth=8,
                                                      sampler_spec=("sobol", 5))),
        ("clamp", lit["night"], T.CameraSettings.make(**NIGHT_CAMERA), 160, 90,
         dict(spp=4, max_depth=8, nee=True, mis=True, clamp=0.5)),
        ("odd_50x31", main_scene, main_cam, 50, 31, dict(spp=3, max_depth=12, sample_index=5)),
    ):
        sc = T.as_scene(sc).to(dev)
        cam = T.derive_camera(cam_s, w, h).to(dev)
        kw = dict(width=w, height=h, t_min=1e-3, frame_seed=3, **kw)
        want, want_rays = mk.render_cuda(sc, cam, return_ray_count=True, **kw)
        got, rays = wf.render_wavefront(sc, cam, return_ray_count=True, **kw)
        small[case] = dict(image_equal=bool(torch.equal(got, want)),
                           ray_counts_equal=bool(torch.equal(rays, want_rays)),
                           image_equal_without_counter=bool(torch.equal(
                               wf.render_wavefront(sc, cam, **kw), want)))
        if not kw.get("clamp"):
            small[case]["regenerate_max_abs"] = float(
                (wf.render_wavefront(sc, cam, regenerate=True, **kw) - want).abs().max())
    emit({"phase": "wavefront_path", "routes_vs_render_cuda": small,
          "launches": {k: v for k, v in mk.LAUNCHES.items() if k.startswith("wavefront")}})
    for case, r in small.items():
        gate("wavefront_path", r["image_equal"] and r["ray_counts_equal"]
             and r["image_equal_without_counter"], f"{case}: {r}")
        gate("wavefront_path", r.get("regenerate_max_abs", 0.0) <= 3e-5, f"{case}: {r}")

    # 22. the FP32 probe (K3): against its plain version, then timed
    xs = torch.linspace(0.5, 1.5, 256 * 128, device=dev).reshape(256, 128)
    peak_errs = {}
    for mix in roofline.MIXES:
        for chains in roofline.CHAINS:
            got = roofline.fma_peak(xs, 32, mix, chains)
            want = roofline.fma_peak_reference(xs, 32, mix, chains)
            peak_errs[f"{mix}x{chains}"] = float(((got - want).abs() / want.abs()).max())
    mk.LAUNCHES.clear()
    peak = roofline.measure_peak()
    peak_launches = mk.LAUNCHES["fma_peak"]
    best = peak["best"]
    x_card = torch.full((peak["n"],), 1.0, dtype=torch.float32, device=dev)
    peak_plain_ms, peak_plain = cuda_ms(lambda: roofline.fma_peak_reference(
        x_card, peak["rounds"], "fma", best["fma"]["chains"]), 1)
    peak_full = roofline.fma_peak(x_card, peak["rounds"], "fma", best["fma"]["chains"])
    peak_full_err = float(((peak_full - peak_plain).abs() / peak_plain.abs()).max())
    emit({"phase": "fma_peak", "max_rel_err_vs_plain_32_rounds": peak_errs,
          "limits": {"slab": 1.2e-7, "fma": 1e-5}, "n": peak["n"], "rounds": peak["rounds"],
          "runs": peak["runs"], "best_tflops": {m: best[m]["tflops"] for m in best},
          "best_share_of_nominal": {m: best[m]["share_of_nominal"] for m in best},
          "nominal_tflops": roofline.NOMINAL_FP32 / 1e12, "launches": peak_launches,
          "max_rel_err_vs_plain_full_rounds": peak_full_err, "plain_ms": peak_plain_ms,
          "card": smi})
    gate("fma_peak", all(v <= (1.2e-7 if k.startswith("slab") else 1e-5)
                         for k, v in peak_errs.items()) and peak_full_err <= 1e-5,
         f"the kernel differs from its plain version: {peak_errs}, {peak_full_err}")
    gate("fma_peak", all(r["share_of_nominal"] <= 1.05 for r in peak["runs"]),
         "a rate above 105% of the nominal peak: the operations are miscounted")
    gate("fma_peak", peak_launches == 6 * (peak["repeats"] + 1),
         f"expected {6 * (peak['repeats'] + 1)} launches, counted {peak_launches}")

    # 23. the f32 / packed-bf16 probe (K4)
    slab_errs = {}
    for dt in (torch.float32, torch.bfloat16):
        for compare in (False, True):
            got = roofline.slab_dtype(xs[:32], 32, dt, compare)
            want = roofline.slab_dtype_reference(xs[:32], 32, dt, compare)
            slab_errs[f"{str(dt).split('.')[1]},compare={compare}"] = float(
                (got - want).abs().max())
    mk.LAUNCHES.clear()
    slab = roofline.bf16_probe()
    slab_launches = mk.LAUNCHES["bf16_probe"]
    card_run = next(r for r in slab["runs"] if r["size"] == "card" and not r["compare"])
    x_slab = torch.linspace(0.5, 1.5, card_run["n"], dtype=torch.float32, device=dev)
    slab_plain_ms, slab_plain = cuda_ms(lambda: roofline.slab_dtype_reference(
        x_slab, slab["rounds"], torch.bfloat16), 1)
    slab_full_err = float((roofline.slab_dtype(x_slab, slab["rounds"], torch.bfloat16)
                           - slab_plain).abs().max())
    # Its least time: its operations a round at the issue rate of the type
    # (roofline.slab_bound_ms), beside the old bound (9 operations a round
    # and element over the FMA peak of the type).
    slab_bounds = {}
    for dt in (torch.float32, torch.bfloat16):
        for compare in (False, True):
            run_c = next(r for r in slab["runs"] if r["size"] == "card"
                         and r["compare"] == compare)
            new_b = roofline.slab_bound_ms(run_c["n"], slab["rounds"], dt, compare)
            old_b = (roofline.SLAB_OPS_PER_ROUND * slab["rounds"] * run_c["n"]
                     / (BF16_PEAK if dt == torch.bfloat16 else FP32_PEAK) * 1e3)
            ms = run_c["bf16_us" if dt == torch.bfloat16 else "f32_us"] / 1e3
            slab_bounds[str(dt).split(".")[1] + (",compare" if compare else "")] = dict(
                ms=ms, bound_ms=new_b, share_of_bound=new_b / ms, old_bound_ms=old_b,
                share_of_old_bound=old_b / ms)
    emit({"phase": "bf16_probe", "max_abs_err_vs_plain_32_rounds": slab_errs,
          "rounds": slab["rounds"], "runs": slab["runs"], "launches": slab_launches,
          "max_abs_err_vs_plain_full_rounds": slab_full_err, "plain_ms": slab_plain_ms,
          "bounds_card_grid": slab_bounds, "card": smi})
    gate("bf16_probe", all(v == 0.0 for v in slab_errs.values()) and slab_full_err == 0.0,
         f"the kernel differs from its plain version: {slab_errs}, {slab_full_err}")
    gate("bf16_probe", slab_launches == 8 * (slab["repeats"] + 1),
         f"expected {8 * (slab['repeats'] + 1)} launches, counted {slab_launches}")

    # 24. render_kernel's schedule: frames and options that stress the
    # per-warp pool, each bit-equal to the wavefront engine without
    # regeneration, ray counts included, and repeatable
    def case(name, scene, cam_s, w, h, **kw):
        return (name, T.as_scene(scene).to(dev), T.derive_camera(cam_s, w, h).to(dev),
                dict(width=w, height=h, t_min=1e-3, frame_seed=3, **kw))

    ow_cam = T.CameraSettings.default()
    regen_rows = regen_schedule(T, mk, wf, [
        case("odd_50x31_spp3", main_scene, ow_cam, 50, 31, spp=3, max_depth=12,
             sample_index=5),
        case("spp1", main_scene, ow_cam, 320, 180, spp=1, max_depth=30),
        case("spp5", main_scene, ow_cam, 160, 90, spp=5, max_depth=30),
        case("spp16", main_scene, ow_cam, 160, 90, spp=16, max_depth=30),
        case("spp37_50x31", main_scene, ow_cam, 50, 31, spp=37, max_depth=30),
        case("band_y1_stride2", main_scene, ow_cam, 320, 90, spp=4, max_depth=30,
             y_offset=1, row_stride=2),
        case("nee_mis_rr", lit["nee"], base_cam, 160, 120, spp=4, max_depth=8,
             russian_roulette_depth=3, **lit_kw),
        case("cornell_nee_mis", T.cornell_box_scene(), T.cornell_camera(), 128, 96, spp=4,
             max_depth=30, **lit_kw),
        case("sobol", main_scene, ow_cam, 160, 90, spp=8, max_depth=30,
             sampler_spec=("sobol", 3)),
        case("stratified", main_scene, ow_cam, 160, 90, spp=16, max_depth=30,
             sampler_spec=("stratified", 4, 4)),
        case("sphere_bvh", final, ow_cam, 160, 90, spp=2, max_depth=50),
        case("icosphere4", mesh_scene(T, 4), mesh_cam, 160, 120, spp=2, max_depth=8),
    ])
    emit({"phase": "regen_schedule", "cases": regen_rows, "card": smi})
    for r in regen_rows:
        gate("regen_schedule", r["ok"], f"{r['case']}: {r}")

    # 25. render_adaptive_kernel's schedule: frames and options that stress
    # its clusters and per-warp regeneration, each tile against the fixed
    # kernel at the tile's count, bit for bit, ray counts included
    ad_kw = dict(adaptive_tol=0.08, adaptive_min_spp=3)
    sched_rows = adaptive_schedule(T, mk, [
        case("ragged_50x31", main_scene, ow_cam, 50, 31, spp=12, max_depth=12,
             **ad_kw) + (True,),
        case("ragged_200x70", main_scene, ow_cam, 200, 70, spp=16, max_depth=30,
             sample_index=5, **ad_kw) + (True,),
        case("band_y1_stride2", main_scene, ow_cam, 320, 90, spp=12, max_depth=30,
             y_offset=1, row_stride=2, **ad_kw) + (False,),
        case("nee_mis_rr", lit["nee"], base_cam, 160, 120, spp=16, max_depth=8,
             russian_roulette_depth=3, adaptive_tol=0.3, adaptive_min_spp=2,
             **lit_kw) + (True,),
        case("cornell_nee_mis", T.cornell_box_scene(), T.cornell_camera(), 128, 96, spp=16,
             max_depth=30, adaptive_tol=0.5, adaptive_min_spp=4, **lit_kw) + (False,),
        case("sobol", main_scene, ow_cam, 160, 90, spp=16, max_depth=30,
             sampler_spec=("sobol", 4), **ad_kw) + (False,),
        case("stratified", main_scene, ow_cam, 160, 90, spp=16, max_depth=30,
             sampler_spec=("stratified", 4, 4), **ad_kw) + (False,),
        case("sphere_bvh", final, ow_cam, 160, 90, spp=8, max_depth=50, **ad_kw) + (False,),
        case("icosphere4", mesh_scene(T, 4), mesh_cam, 160, 120, spp=8, max_depth=8,
             **ad_kw) + (False,),
        case("aov_normal", main_scene, ow_cam, 300, 140, spp=8, max_depth=8, mode="normal",
             adaptive_tol=0.02, adaptive_min_spp=2) + (False,),
    ])
    emit({"phase": "adaptive_schedule", "cases": sched_rows, "card": smi})
    for r in sched_rows:
        gate("adaptive_schedule", r["ok"], f"{r['case']}: {r}")
        gate("adaptive_schedule", any(k.endswith("+adaptive+rays") for k in r["launches"]),
             f"{r['case']}: no adaptive launch counted: {r['launches']}")
    # 26-28. gradients through the kernels, the inverse-rendering loop and
    # the denoised main frame; 29. the AOV kernel's staged scan
    phase_grad(T, mk, dev, smi)
    phase_inverse(T, mk, dev, smi)
    guides_row = phase_denoise(T, mk, dev, smi)
    aov_scan = phase_aov_scan(T, mk, dev, smi)
    # 30. the command line end to end
    phase_cli(T, mk, dev, smi, frame_ms)
    # 31. the sharded path (K1, K2) on 1, 2 and 4 ranks; 32. threefry
    phase_sharded(T, mk, dev, smi, main_img)
    phase_threefry(T, mk, dev, smi)
    # 33. the wavefront bounce kernel's staged sphere scan
    wf_stage = phase_wf_stage(T, mk, wf, dev, smi)
    # 34. render_kernel's staged BVH route on its edge cases; 35. the other
    # global BVH walks
    bvh_stage_row = phase_bvh_stage(T, mk, wf, dev, smi)
    phase_global_walks(T, mk, smi)

    ad_alone = time_adaptive(T, mk, 5)

    def rays_of(sc, cam, kw):
        return float(mk.render_cuda(sc, cam, return_ray_count=True, **kw)[1].double().sum())

    kernel = dict(route="cuda", source=KERNEL_SOURCE, replaces=REPLACES)
    main_bound = bound(T, mk, main_dev, main_rays, 3 * 4 * 1280 * 720, main_share)
    rows = [
        dict(kernel, name="megakernel:brute+staged", path="brute+staged",
             launches=launches.get("megakernel:brute+staged", 0),
             max_abs_err=m6.max_abs, ms=frame_ms, plain_ms=plain_ms, **main_bound,
             kernel_ms=main_kernel["kernel_ms"]),
    ]
    for p in (paths["config3"], paths["config4"], paths["mesh_bvh+nee+staged"],
              nee_runs["night"], paths["brute+sobol+staged"]):
        sc, cam, kw = p["inputs"]
        b = bound(T, mk, sc, rays_of(sc, cam, kw), 3 * 4 * kw["width"] * kw["height"],
                  p["root_share"], p.get("walks"))
        row = dict(kernel, name="megakernel:" + p["route"], path=p["route"],
                   launches=p["launches"].get("megakernel:" + p["route"], 0),
                   max_abs_err=p["match"].max_abs, ms=p["ms"], plain_ms=p["plain_ms"],
                   kernel_ms=p.get("kernel_ms"), **b)
        if T.as_scene(sc).sphere_bvh is not None or T.as_scene(sc).mesh is not None:
            # The BVH routes: the walk render_kernel took, its stage, the
            # blocks an SM with it, and (phase 34) the staged edge cases.
            stage = mk.route_of(T.as_scene(sc)).bvh_stage
            row.update(walk="staged" if stage else "global", stage_bytes=stage,
                       blocks_per_sm=mk.render_occupancy(kw.get("nee", False), False,
                                                         "bvh" if stage else "global", stage),
                       bvh_stage_cases=bvh_stage_row)
        rows.append(row)
    # render_aov_kernel: BASELINE config 1, one primary ray a pixel.
    sc1, cam1, kw1 = paths["config1"]["inputs"]
    rows.append(dict(kernel, name="megakernel:brute+aov_normal", path="brute, normal AOV",
                     launches=paths["config1"]["launches"].get("megakernel:brute", 0),
                     max_abs_err=paths["config1"]["match"].max_abs, ms=paths["config1"]["ms"],
                     plain_ms=paths["config1"]["plain_ms"],
                     kernel_ms=paths["config1"]["kernel_ms"],
                     **bound(T, mk, sc1, float(kw1["width"] * kw1["height"]),
                             3 * 4 * kw1["width"] * kw1["height"],
                             paths["config1"]["root_share"])))
    # render_aov_kernel's guides mode: the denoiser's three planes in one
    # launch at the main frame (phase 28; its launches are the denoised
    # frame's), 14.7 M primary rays on 197 spheres, 36 bytes a pixel out.
    rows.append(dict(kernel, name="megakernel:brute+guides", path="brute, guides (phase 28)",
                     launches=guides_row["launches"], max_abs_err=max(
                         guides_row["max_abs"], aov_scan["max_abs"]),
                     ms=guides_row["kernel_ms"], plain_ms=guides_row["plain_ms"],
                     kernel_ms=guides_row["kernel_ms"], denoised_frame_ms=guides_row[
                         "denoised_ms"], aov_scan_launches=aov_scan["launches"],
                     **{k: guides_row[k] for k in ("bound_ms", "bound_by", "rays_traced",
                                                   "root_share", "bound_is_lower_bound",
                                                   "library_ms")}))
    # The adaptive rows: the main frame (phase 17) and the Cornell box, the
    # NEE instance (phase 15).
    cb = adaptive_runs["cornell"]
    rows.append(dict(kernel, name="megakernel:brute+adaptive", path="brute+adaptive",
                     launches=ad_launches.get("megakernel:brute+adaptive", 0),
                     max_abs_err=m17.max_abs, ms=ad_ms, plain_ms=ad_plain_ms,
                     kernel_ms=ad_alone["adaptive_main"]["kernel_ms"],
                     cluster_blocks=ad_cluster,
                     **bound(T, mk, main_dev, ad_rays, (3 + 2 * 6) * 4 * 1280 * 720, ad_share)))
    rows.append(dict(kernel, name="megakernel:" + cb["route"], path=cb["route"],
                     launches=cb["launches"].get("megakernel:" + cb["route"], 0),
                     max_abs_err=cb["match"].max_abs, ms=cb["ms"], plain_ms=cb["plain_ms"],
                     kernel_ms=ad_alone["adaptive_cornell"]["kernel_ms"],
                     cluster_blocks=cb["cluster"],
                     **bound(T, mk, cb["scene"], cb["rays"], cb["out_bytes"],
                             cb["root_share"])))
    n_salts, n_pairs = len(salts), len(pairs)
    probe_bytes = {"hash_probe": 4 * (values.size * (1 + 2 + 2 * n_salts) + n_salts),
                   "sampler_probe": 2 * 4 * values.size * (2 + 2 * n_pairs)}
    rows += [
        dict(kernel, name=name, path=name, replaces=PROBE_REPLACES[name], **p,
             bound_ms=probe_bytes[name] / HBM_RATE * 1e3, bound_by="bytes",
             library_ms=None)
        for name, p in probes.items()
    ]
    # K2: the wavefront bounce kernel on the main frame.  Its least time is
    # the megakernel's (the same rays and primitive tests) or the state
    # traffic: every live ray reads 16 words of state (+ its sample, and
    # under regeneration its bounce) and writes 14 (15) per bounce.  `ms` is
    # the bounce kernels' device time a frame (the profiled frame) over
    # their launches.
    for mode, words in (("off", 17 + 14), ("on", 18 + 15)):
        wv = wave[mode]
        t_ops = main_bound["bound_ms"]
        t_bytes = wv["stats"]["live_ray_bounces"] * words * 4 / HBM_RATE * 1e3
        frame_launches = wv["stats"]["enqueued"]["bounce"]
        rows.append(dict(kernel, name=wv["route"], path=wv["route"],
                         replaces=WAVEFRONT_REPLACES,
                         launches=wv["launches"].get(wv["route"], 0),
                         max_abs_err=wv["max_abs"],
                         ms=wv["busy"]["bounce_kernel_ms"] / frame_launches,
                         frame_ms=wv["ms"], bounce_kernels_ms_per_frame=wv["busy"][
                             "bounce_kernel_ms"], plain_ms=wv["plain_ms"],
                         bound_ms=max(t_ops, t_bytes) / frame_launches,
                         bound_by="operations" if t_ops >= t_bytes else "bytes",
                         bound_ms_per_frame=max(t_ops, t_bytes),
                         state_traffic_ms=t_bytes, rays_traced=main_rays,
                         bound_is_lower_bound=False, library_ms=None,
                         sphere_scan=wv["stats"]["sphere_scan"],
                         wf_stage_routes=wf_stage["routes"],
                         wf_stage_launches=wf_stage["launches"]))
    # The device loop's own kernels (wavefront.cu; the ray generation in
    # megakernel.cu), timed at the main path's shape (time_partition);
    # launches are the regeneration-off frames' of phase 21.
    wv = wave["off"]
    for row_name, key, source, replaces in (
            ("wavefront_partition", "partition", WAVEFRONT_SOURCE, WAVEFRONT_LOOP_REPLACES),
            ("wavefront_raygen", "raygen", KERNEL_SOURCE, WAVEFRONT_RAYGEN_REPLACES),
            ("wavefront_advance", "advance", WAVEFRONT_SOURCE, WAVEFRONT_LOOP_REPLACES)):
        t = wf_parts[key]
        # The largest difference from the plain version at the main path's
        # shapes (phase 21): planes gathered, rays filled and refilled,
        # counts stepped.
        fields = {"partition": ("planes_max_abs",), "raygen": ("fill_max_abs", "refill_max_abs"),
                  "advance": ("counts_max_abs",)}[key]
        err = max(r.get(f, 0.0) for r in main_part + [wf_parts["match"]] for f in fields)
        extra = {}
        if key == "partition":
            # A frame's partition calls (the profiled frames of phase 21):
            # [slots, live rays, compacted, ranked a refill, device ms].
            extra = {f"frame_{mode}": dict(
                ms=wave[mode]["busy"]["partition_kernels_ms"],
                by_kernel_ms=wave[mode]["busy"]["partition_by_kernel_ms"],
                calls=[[c["n"], c["live"], int(c["compact"]), int(c["rank"]), c["ms"]]
                       for c in wave[mode]["calls"]["calls"]])
                for mode in ("off", "on")}
        rows.append(dict(t, route="cuda", source=source, replaces=replaces, name=row_name,
                         path=f"main frame, {wf_parts['slots']} slots",
                         launches=wv["launches"].get(row_name, 0), max_abs_err=err,
                         library_ms=t.get("library_ms"), **extra))
    # K3: its counted operations over the nominal FP32 peak.  K4: its 9
    # operations a round and element at the issue rate of the type; the row
    # times the packed bf16 kernel and carries the f32 kernel's time and
    # bound beside it.
    fma_best = best["fma"]
    rows.append(dict(route="cuda", source=PROBES_SOURCE, replaces=FMA_PEAK_REPLACES,
                     name="fma_peak", path=f"fma x{fma_best['chains']}",
                     launches=peak_launches, max_abs_err=peak_full_err, ms=fma_best["ms"],
                     plain_ms=peak_plain_ms, bound_ms=fma_best["flops"] / FP32_PEAK * 1e3,
                     bound_by="operations", library_ms=None,
                     measured_tflops={m: best[m]["tflops"] for m in best}))
    k4 = slab_bounds["bfloat16"]
    rows.append(dict(route="cuda", source=PROBES_SOURCE, replaces=BF16_PROBE_REPLACES,
                     name="bf16_probe", path="bf16, card-filling grid",
                     launches=slab_launches, max_abs_err=slab_full_err,
                     ms=k4["ms"], plain_ms=slab_plain_ms, bound_ms=k4["bound_ms"],
                     bound_by="operations", library_ms=None, old_bound_ms=k4["old_bound_ms"],
                     f32_ms=slab_bounds["float32"]["ms"],
                     f32_bound_ms=slab_bounds["float32"]["bound_ms"],
                     f32_old_bound_ms=slab_bounds["float32"]["old_bound_ms"]))
    # The main path's bound at the FP32 rate K3 measured on the traversal
    # mix, beside the nominal one (the nominal stays `bound_ms`).
    for row in rows:
        if row["name"] in ("megakernel:brute+staged", "wavefront:brute",
                           "wavefront:brute+regen"):
            row["bound_ms_at_measured_slab_rate"] = (
                main_rays * ray_flops(T.as_scene(main_dev), main_share)
                / (best["slab"]["tflops"] * 1e12) * 1e3)
    emit({"kernels": rows})
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED {f}", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
