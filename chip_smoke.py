#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`gsplat_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):
  1. device: the card's name and power limit (nvidia-smi);
  2. build: compile every kernel of `gsplat_tpu_torch/csrc/` (nvcc, sm_90a,
     one process per source, all at once);
  3. K3 cull at the bench shape (1M Gaussians, 1920x1080, tile 32, K 64):
     the compact stage (compact_k and counts, the base tiers' route) and the
     mask stage against their plain PyTorch versions on the card, 0
     differing entries allowed; the kernel, the plain version and the route
     it replaced (the mask stage, where, row sort, sum) timed with CUDA
     events; then hand-made rows with a NaN in each parameter (count > 0
     where the NaN is elsewhere) through the mask, compact, rank and count
     stages, 0 differing entries; then the 'packed' route's count and
     emit stages (`check_packed_stages`) on the same rows at a 4.1M-slot
     stream, whole frame, without the cull and on a band of half the tile
     rows: 0 differing entries, their times beside their bounds, the mask
     stage's and the plain versions', and their launch counts; and the
     'tiered' route's tier count and tier emit (`check_tier_stages`) on the
     bench ladder's rows of that view, whole frame and a band of half the
     tile rows, into the 4.1M-slot stream and one 1000 slots short of the
     candidates: 0 differing entries, as many slots written as kept, their
     times beside their bounds and the plain versions', their launches;
  4. K1 blend at the bench shape on the port's own binned stream, float32
     and packed4: kernel against the plain tiled walk (of the unpacked
     stream) on the card, PSNR >= 60 dB and >= 99.99% of pixels within 1e-4
     on image and transmittance (the serial product and the log-domain
     cumsum round differently at the 1e-4 termination threshold); the
     pairs walked when each pixel, each 32-pixel warp, each warp of the
     kernels' walk (a 32x2 strip) or each tile walks as far as its slowest
     pixel (`raster_torch.walked_pairs`), and the share of the walk's
     (warp, Gaussian) steps that the power floor skips;
  5. K2 blend backward on the same streams, with N(0, 1) upstream gradients
     of image and transmittance: kernel (fed K1's outputs) against the plain
     re-walk (fed the plain forward's). Float32: each feature row within
     1e-3 relative L2 and >= 99.9% of the walked slots within rtol 2e-3 /
     atol 2e-4 (the JAX per-slot tolerance). Packed4 in, bf16 pairs out,
     against the plain re-walk packed to pairs: the unpacked rows within
     1e-3 relative L2 and >= 99.9% of the walked slots within the float32
     tolerance plus one bf16 ulp (each side rounds its float32 sum by at
     most half an ulp; the share within one ulp alone is printed). The
     slots past the stream exactly 0 in both, and a second launch on the
     same inputs bit-identical (no atomics);
  6. K4 segmented suffix sum on K2's float32 gradients sorted gid-major,
     and K5 on K2's bf16 pairs (depth 64): kernel against the plain
     doubling, each value within 1e-6 + 1e-5 times the summed span's
     absolute sum (only the float32 addition order differs; for K5 or
     within one bf16 ulp, where that order flips a rounding); K5's
     zero-high (opacity) lanes keep their low halves; a second launch of
     each bit-identical. Then hand-made run layouts (`segsum_layout`, at
     kmax 2048 and 64: runs of 1 to 2048 slots starting and ending on the
     scan's warp, round and chunk edges, a run of kmax crossing a chunk
     edge, M not a multiple of 2048, a zero tail longer than the depth, one
     run holding a NaN) through K4 (F = 9) and K5 (P = 5) against their
     plain versions: the same tolerances, NaNs at the same places and only
     inside their run, a relaunch bit-identical;
  7. the realistic scene (1M Gaussians, heavy-tailed) with the jumbo tiers
     of bench.py:246-253: K3's rank stage on the (14,848, 2048) jumbo grid
     against its plain version (mask, rank and counts, 0 differing entries
     each), timed beside the route it replaced (the mask stage, cumsum,
     sum), and on the same rows bounded at K 1024 (the viewer preset's
     K_jumbo; lanes kept, 0 differing entries); the tier count and tier
     emit as in 3 on its base and jumbo tiers' rows (the jumbo rows keep
     candidates); K1 and K2 (packed4, bf16 pairs out)
     on its view-0 stream, whose jumbo splats make the longest segments,
     against their plain versions with the tolerances of 4 and 5; and K5
     and K4 at depth 2048 on K2's pairs of that stream (K4 on the pairs
     unpacked to float32) against their plain versions with the tolerances
     of 6, each relaunch bit-identical;
  8. golden: the JAX reference scene (tests/golden/scene_42_300.npz) through
     K3 and K1, above 55 dB against tests/golden/render_64.npz; packed16 K1
     and K2 at that shape against their plain versions; its stream at
     tile_culling=False (no cull drops a Gaussian before the blend) with
     every 17th slot's opacity NaN, float32 and packed4: K1's image and T
     within 1e-4 of the plain walk's and K2's float32 and bf16-pair
     gradients within the tolerances of 5, NaNs at the same places in both
     (a NaN-opacity pair is skipped, as the plain version skips it);
  9. main paths, each driven with the launch counts set to 0 just before
     and read just after:
     - serving, float32 (bench.py --exact-grads's stream): `render` of the
       1M-Gaussian SH-3 random scene at 1920x1080 for four views;
     - training, exact (bench.py --exact-grads), on the captured step
       (`make_train_step`): L1 + 0.2 DSSIM, Adam at lr 1e-2, from a copy
       of the scene whose SH DC carries seeded noise,
       against renders of the scene itself, one view per step; the random
       scene, then the realistic scene with the jumbo tiers (K4 at depth
       2048);
     - serving, packed4 (bench.py's default stream): the random scene, and
       the realistic scene with the jumbo tiers;
     - training, bench default (bench.py with no flags: packed4, bf16-pair
       gradients through K5): the same recipe on both scenes.
     Every frame has no overflow, intersections, a finite non-black image;
     every step no overflow, finite gradients and a finite loss, and the
     last round's mean loss below the first's; each path launched each of
     its kernels;
 10. the user surface, three more main paths:
     - cli_train: `cli train` at the bench-default config (K_max 128) on a
       1M random target, a fresh 1M init padded to 1.25M, 8 training and 2
       held-out orbit views, 180 steps with densification every 20 from 20
       to 80, one opacity reset (at 90), the staged capacity at 1.3x,
       evals every 40, checkpoints every 60, --overflow-policy raise; then a
       resume from the step-60 checkpoint. The last log row's loss below the
       first's, the last held-out PSNR above the first (step 40's), a round
       that split or cloned, the capacity tightened, the PLY equal to the
       last checkpoint's scene within rtol 1e-6. The first training step's
       own inputs to K3's compact stage (K 128) and to K5 (depth 128) then
       go through the kernels and their plain versions again: K3 0
       differing entries, K5 the tolerances of 6 and a relaunch
       bit-identical; the fit captured 1 + its capacity rebuilds train-step
       graphs;
     - bench: `run_bench` of {fwd, fwd_bwd} x {random, realistic} x
       {default, --exact-grads} (`gsplat_tpu_torch.bench.preset`, the
       realistic runs with the default headline's jumbo ladder, iters
       10), each free of overflow with view 0's intersections of the
       matching serve path; and the ninth, `--viewer` (800x800, forward,
       K_max 32, jumbo tiers to 1024; the arguments
       `gsplat_tpu_torch.bench.main` makes for the flag), free of
       overflow, below its 2,330,000 capacity, through K3's rank stage;
       each window's timed call making 0 synchronising calls per
       iteration (`torch.cuda.set_sync_debug_mode`), and each run one
       CUDA graph captured (`render_jit` or `render_loss_and_grad`);
     - cli_render: `cli render` of the trained PLY with --viewer-preset
       --pad-bucket --orbit 4; orbit view 0's own inputs to K3's compact
       stage (K 32) and rank stage (the jumbo grid, K 1024, which holds no
       lanes at 800x800: 7 checks K 1024 with lanes) through the kernels
       and their plain versions, 0 differing entries; each PNG read
       back equal to `to_uint8` of the image rendered again (the PNG
       round trip: K1 at this tile size and stream format is held to its
       plain version in 4 and 7);
 11. the cost probes of scripts/micro_kernel_costs.py (P1-P4) at its
     shapes, each kernel against its plain version on the card: P1 (2^29
     elements) mults and fast3 bit for bit, exact and exact3 within 2 ulp;
     P2 (4096 x 1024 rows of 128; first 16 and 37 rows) each precision
     within 1e-5 of the plain passes, and against the float32 cumsum of
     x[:4] `default` within 2^-8 of the running sum of |x|, `high` and
     `highest` within 1e-5; P3 and P4 bit for bit on in-range indices
     (`probe_inputs`). Kernel ms, bound, plain ms and, for P2 highest
     (torch.matmul), P3 (take_along_dim) and P4 (advanced indexing), the
     library call's ms; P3 beside the launch floor (torch.cuda._sleep(0)
     back to back, `launch_floor_ms`), P4 also after an L2 flush. Then the
     edge-index check: `probe_edge_indices` (every edge of P3's and P4's
     index rules, in range and out of it) through both kernels at the
     script's shapes and at shapes that take their scalar routes, equal to
     the plain versions in raw bits (NaN at the same places; P4 none).
     Then the `probes` main path: `micro_kernel_costs.main(["all"])` with
     the counts at 0, which must launch all four;
 12. golden gradients: `render_loss_and_grad` of the golden scene on the
     card against the port's plain path on the CPU, which the CPU tests hold
     to JAX: exact f32 (K2, K4) every field within rtol 5e-3 / atol 1e-5;
     bench default (packed K1 and K2, K5) every field within 1e-5 + 1e-2 of
     its largest value and >= 99% of entries within 1e-5 + 8e-3 of their
     own (one or two bf16 ulps: tests/test_torch_packed_train.py).
 13-17. the multi-device paths (`check_multi_device`), each a main path
     whose launches are counted in its ranks, reset before it and read
     after, and summed over the ranks. D ranks share cuda:0, spawned by
     `parallel.multihost.launch` (rendezvous on a free TCP port, joined
     with a limit: one failed rank fails the phase) over gloo, which stages
     every collective through host memory; the bench config with the 1M
     random scene (seed 0) at 1920x1080, tile 32 (tiles_y 34, so D = 2
     divides it). The per-shard capacity is measured first
     (`shard_capacity`: 1.15x the largest band's demand over the four
     views; the bench's 4.1M // 2 overflows the top band of view 0):
     13. tile_sharded (tiles 2): `render_tile_sharded`, float32 and
         packed4, four views; the gathered image and T against the
         single-device render within rtol 1e-4 / atol 1e-5 (1e-6) on every
         pixel (`tests/test_sharding.py:51-55`; bit-identical: the band's
         keys pack the global depth bits and sort stably); each rank's
         own K3 compact inputs against the plain version, 0 differing
         entries; rank 1's K1 at tile_offset 1020 on its own stream of
         each format against the plain walk, the tolerances of 4. Then
         tile_sharded_fit: `fit(mesh=...)` of a noisy-DC copy padded to
         1.25M, 60 steps, one densify round (30), a checkpoint by rank 0
         (50) and a resume from it; the last log row's loss below the
         first, the resume's rows equal to the run's, only rank 0 logs,
         the two ranks' scenes bit-identical;
     14. tile_sharded_train (data 2 x tiles 2, four ranks): the bench
         default (packed4, bf16 pairs, K5) 20 steps, then --exact-grads
         (K4) 6 steps, two views a step; the first step's loss within
         rel 1e-5 of `make_train_step` on the same two views and >= 99.9%
         of each field's gradients within rtol 5e-3 / atol 5e-5 (bf16) or
         2e-3 / 2e-6 (f32); the loss falling; the scene bit-identical on
         all four ranks; rank 3's K2 at tile_offset 1020 on its own inputs
         against the plain re-walk, the tolerances of 5;
     15. gaussian_sharded (gauss 2): the config-5 settings (tiered,
         packed16 wire, fragment_format 'bf16', DEFAULT's gradients), the
         scene padded to 1.25M; `fragment_occupancy` first, whose
         suggestion (the largest segment of the views, 1.15x) is the
         path's per-dest capacity; the render of the four views, one train
         step, `fit_gaussian_sharded` 40 steps with one densify round and a
         per-shard checkpoint at 40, reloaded bit for bit; the renders
         against the single-device packed16 render (>= 97% of pixels
         within rtol 1e-3 / atol 1e-4, PSNR >= 60 dB: tied depths,
         GAUSS_RENDER_WITHIN), the step's shard-local gradients against
         the single-device step's rows (>= 99.9% within 5e-3 / 5e-5),
         `visible` equal; the fragment exchange's bytes per step printed;
     16. sharded_bench: `torchrun --standalone --nproc-per-node 2 -m
         gsplat_tpu_torch.cli bench --sharded-tiles 2 --device cuda:0
         --dist-backend gloo` at the bench config and the measured
         capacity, and `-m gsplat_tpu_torch.bench --gaussian-sharded 2`
         the same way: each prints its JSON line once (rank 0), without
         overflow (their launches happen in torchrun's processes and are
         not counted);
     17. nccl_world1: one rank on NCCL, a tile-sharded frame (tiles 1) and
         a Gaussian-sharded train step (gauss 1), both bit-identical to the
         single-device port.
 18. the ports of the root tools, each a main path (`check_tools`):
     - scene_report: `python -m gsplat_tpu_torch.scene_report` of the 1M
       random scene at the bench's flags, orbit 4, camera 0's
       intersections equal to view 0's of the serve path; then the
       realistic scene with the jumbo ladder, its jumbo block printed;
     - train_protocol: `gsplat_tpu_torch.train_protocol.main` at its full
       512x512 shape cut to 1200 steps (`PROTOCOL_ARGV`): no overflow under
       'raise', a densify round that split or cloned, the capacity
       tightened, the loss falling, the last held-out PSNR finite and
       above the first eval's; after the path, the first step's own
       inputs to K3 (compact, K 128), K1 and K2 (packed16, tile 16, bf16
       pairs out) and K5 against their plain versions with the tolerances
       of 4-6, each relaunch bit-identical; then 0 synchronising calls per
       train step, and as many in `fit` at 3 steps as at 6
       (`check_step_syncs`);
     - train_sharded_smoke: the module's rank body at its shape (128x128,
       350 steps) on data 2 x tiles 2, four ranks sharing cuda:0 over
       gloo, and its asserts (loss, PSNR, scene alive, more alive than
       the init: a densify round split or cloned);
     - fit_demo: 800 steps of `gsplat_tpu_torch.fit_demo` per stream
       (f32; packed16 and packed4 with --fast), each view-0 PSNR finite
       and >= 5 dB above its initial render's, printed beside the JAX
       demo's TPU readings.
   19. the captured paths (`utils/graphs.py`: one CUDA graph per static
     key, captured by the first call and replayed after). Each path's
     count wraps its captured calls alone (the first call, which warms up
     and captures, and the replays): their launches are the wrappers'
     counts at warm-up plus each graph's counted launches per replay. The
     eager references, timing, sync counts and profiled passes run after
     the count is read:
     - render_jit (`check_render_jit`): the random and realistic 1M scenes,
       float32 and packed4, the four views in turn twice; every output
       bit-identical to eager `render`'s, one capture per (cfg, scene), 0
       synchronising calls per replay, the profiler's records of a replay
       naming K3 and K1 as often as the graph counts them;
     - train_jit (`check_train_jit`): the exact and bench-default steps on
       both scenes, 10 captured steps (`make_train_step`) from one init
       against 10 steps of `make_eager_train_step` from a second copy:
       losses, tap gradients, visibility and final parameters
       bit-identical (or, named, within rtol 5e-3 / atol 1e-5, with the
       ops that have no deterministic implementation listed), 0
       synchronising calls per replay, the profiler naming K2 and K4 or
       K5 as often as the graph counts them;
     - loss_and_grad_jit (`check_loss_and_grad_jit`): `render_loss_and_grad`
       (bench default, random scene) over the four views twice, each
       bit-identical to its eager body, 0 synchronising calls per replay,
       the profiler's records of the bench's own fwd_bwd call
       (`bench_iteration`) naming K3, K1, K2 and K5 as often as the graph
       counts them.
     Then, as a reference and not a path, phase 10's `cli train` recipe on
     the eager step (`check_cli_train_eager`): its held-out PSNR at step
     180 equal to the captured run's (phase 10 also requires 1 + the
     capacity rebuilds train-step captures; this reference runs the
     densify round eagerly too). Eager against replayed ms per
     frame and step (CUDA events and the host clock, medians), the replays'
     busy share from one profiled pass, and the peak memory of each kind's
     calls.
 20. the multi-device programs as CUDA graphs on NCCL
     (`check_multi_device_jit`): first `check_nccl_share`, NCCL's refusal
     of two ranks of one host on one card (quoted) and, with
     `multihost.share_card_env`, all_reduce, all_gather and
     all_to_all_single right eagerly and replayed from graphs captured in
     each capture_error_mode; then JIT_RANKS NCCL ranks sharing cuda:0
     (`rank_multi_device_jit`) at the capacities phases 13 and 15
     measured, six paths, each counted on its captured calls alone and
     summed over the ranks: tile_sharded_jit (`render_tile_sharded_jit`,
     f32 and packed4, the four views twice, bit-identical to the eager
     function and to the single-device `render`), gaussian_sharded_jit
     (packed16 wire, bit-identical to the eager body), sharded_train_jit
     (data 1 x tiles 2, bench default and --exact-grads) and
     gaussian_train_jit (10 captured steps against 10 eager ones from a
     second copy: losses, tap gradients, visibility and parameters
     bit-identical, or named and within rtol 5e-3 / atol 1e-5),
     fit_mesh_jit (`fit(mesh=...)` 60 steps with a densify round against
     the same fit on the eager step and round: log rows and scenes
     equal), densify_jit (the Gaussian-sharded densify program and
     `densify_and_prune_jit`, bit-identical to their eager bodies). Each
     program: one capture per key per rank, 0 synchronising calls per
     replay, the profiler's records of a replay naming its kernels and one
     NCCL kernel per collective as the graph counts them, eager against
     replayed ms per rank, the busy share and the peak memory.
 21. BASELINE config 5 at its own size (`check_config5`): the config of
     scripts/probe_config5_memory.py (3840x2048, tile 32, packed binning
     at K_max 64, 8.8M slots, packed16, bf16 pairs) on
     `config5_memory.config5_scene` (random_scene seeded 0, its log-scales
     moved by -ln 2, a cut of the workload, so that no rect passes K_max
     at 4K), four main paths, each counted on its captured calls alone:
     - config5_proxy: `config5_memory.proxy_run`, the captured step at
       one of 16 shards' shapes (375k Gaussians, the whole 4K target) for
       4 steps, then the eager body from a second copy, bit-identical, no
       overflow, a finite loss; the memory fields (argument, output, peak,
       temp, reserved) of both;
     - config5_single: `render_jit` of the 6M scene for the four views
       scaled to 4K at 1.15x their largest intersections, the reference
       of config5_ranks (view 0's tied (tile, depth) pairs printed; K3's
       count and emit stages on view 0's 6M x 64 lanes as in phase 3); the
       ranks' capacities measured shard by shard
       (`config5_memory.measure_capacities`);
     - config5_ranks: 2 NCCL ranks sharing cuda:0, 3M Gaussians each:
       `render_gaussian_sharded_jit` of the four views against the
       reference (>= GAUSS_RENDER_WITHIN of pixels within rtol 1e-3 / atol
       1e-4, PSNR >= 60 dB), 3 captured steps, then 3 eager ones from
       the same state, bit-identical, finite, no overflow; one capture per key
       per rank, 0 syncs per replay; per rank the peak memory, replay and
       eager ms; the exchange's bytes per step; K3's count and emit stages
       (each rank), K1 and K2 on the heaviest tile row of rank 0's merged
       packed16 stream and K5 on rank 0's own inputs against their plain
       versions, the tolerances of phases 3-6;
     - fourk: 2M random Gaussians at 3840x2160, the bench default with the
       jumbo tiers to 256 tiles, the tier and jumbo budgets sized by
       `scene_report` at that shape and the capacity by the render's
       intersections: `render_jit` of view 0, then 5 captured steps
       against 5 eager ones, bit-identical, no overflow, the loss finite
       and falling; K3's compact and rank stages and K5 on the path's own
       inputs, K1 and K2 on its heaviest tile row.
     Then, not a main path, (d): the proxy and the 2 ranks on the
     script's own draw (shift 0), capacities measured at that draw:
     memory per rank, exchange bytes, ms; replays bit-identical to eager
     and losses finite; overflow (rects past K_max 64) reported.
 22. Feature 3DGS's K6 and K7 (`check_features`), packed4 with 128
     channels, on a 1080p view of the benchmark's feature cell (its 1M
     garden scene, seed FEAT_SEED, view FEAT_VIEW): K6's colour and
     transmittance K1's bit for bit; on the heaviest tile row, against
     the plain walks on CPU copies of the stream, the colour within K1's
     tolerance, the feature map's RMSE <= 1e-6 with >= 99.99% of pixels
     within 1e-5, the slot and table gradients within 1e-5 of the plain
     walk's largest magnitude, and K7's slot gradients outside the row 0;
     both kernels timed beside K1 and K2 and their bounds (the
     reference's tally); then the main path feat3dgs, FEAT_STEPS captured
     train steps and a `render_jit` frame: K6 once a step and a frame, K7
     once a step.
 23. The projection's K8 and K9 (`check_projection`) on the first view of
     bicycle's 6M scene (3840x2048) and of garden's 1M scene (1920x1080),
     the benchmark cells' configurations, seed PROJECT_SEED: K8's outputs
     against `_project_plain` run on the card (mask, rect, counts, radius
     equal on >= 99.99% of the Gaussians, overflow equal, each float
     output bit-equal on >= 99.9% of its elements and the rest within
     PROJECT_ULPS); K9's gradients for N(0, 1) upstream gradients against
     autograd of `_project_plain` (>= 99.99% of each field's entries
     within rtol 5e-3 / atol 1e-5, all finite), both beside autograd in
     float64; K9 with the upstream gradients zeroed off the mask, zeros
     there; K8, K9 and the plain versions timed beside the bytes' bound;
     then the main path project, 2 captured bicycle frames and 2 captured
     garden steps: K8 once a frame or step, K9 once a step; the two
     graphs' nodes by type.
 24. 2D Gaussian splatting's K10-K13 (`check_surfels`) on the first view
     of the benchmark's surfel cell (its 1M garden surfels at 1920x1080,
     seed SURF_SEED): K12 against `_project_surfels_plain` on the card
     (depth bit-equal; mask, rect and counts equal on >= 99.99% of the
     surfels; the other outputs within rtol 2e-5 / atol 1e-5), K13
     against its autograd (>= 99.99% of each field's entries within rtol
     5e-3 / atol 1e-5); on the heaviest tile row, K10's five maps against
     the plain walk of each tile (within 2e-4 of max(1, the map's
     largest)) and K11 with K4's sums against its autograd (each table
     column's gap of norms within 1e-4, the centre's within 1e-2), K11's
     slot gradients outside the row 0; all four timed beside the plain
     versions and their bounds (the reference's tally); then the main path
     surfels, SURF_STEPS captured train steps and a `render_jit` frame: K12
     and K10 once a step and a frame, K13 and K11 once a step, K4 twice a
     step, no 3DGS blend or projection kernel; the step graph's nodes.
     Each phase prints its seconds.
Then one JSON line of kernel numbers, each kernel with its launches on each
main path (`launches_by_path`, and their sum as `launches`; K3's rank stage
on the jumbo grid, its count and emit stages on the 'packed' paths also
alone, `{rank,count,emit}_launches_by_path`), and as the last
line {"ok": true, "device": {...}}. Needs one CUDA card; exits non-zero
without.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and FP32
# FLOP/s outside the tensor cores. A bound is the larger of bytes over the
# first and operations over the second.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# K3: FP32 operations the cull does, as csrc/cull.cu's note counts them:
# per (row, k) lane, k div/mod w 5, tile origin 2, pixel-rect offsets 8,
# inside test 4, four edges of 11, min and tests 7; per row, -b/a, -b/c and
# 2b: 5. Bytes per row, besides its 10 float32 parameters: the mask stage
# writes kmax (bool), the compact stage 4 kmax + 4 (compact_k, counts), the
# rank stage 5 kmax + 4 (mask, krank, counts).
CULL_OPS_PER_LANE = 70
CULL_OPS_PER_ROW = 5
CULL_OUT_BYTES = {"mask": (1, 0), "compact": (4, 4), "rank": (5, 4),
                  "count": (1 / 8, 4)}
# K3's emit stage: bytes written per kept slot (int64 key, int32 gidk) and
# read per row (x0, y0, w, the offset, the depth key; the ballot words on
# top, 4 bytes per 32 lanes).
EMIT_SLOT_BYTES = 12
EMIT_ROW_BYTES = 24
# K3's tier count and tier emit: bytes per tier row (the count read, its
# kept count written; the emit reads its offset) besides the emit's 12 per
# kept slot.
TIER_COUNT_ROW_BYTES = 8
TIER_EMIT_ROW_BYTES = 4
# K1: FP32 operations per (pixel, Gaussian) pair a pixel walks: 12 for the
# offset, the quadratic and its test on every walked pair, about 15 more
# (one exp) for the pairs that pass it -- about 20 on average.
BLEND_OPS_PER_PAIR = 20
# K2, as csrc/raster_bwd.cu counts them: 20 for every pair a pixel walks
# (blend.cuh's eval_pair); 33 more for every pair it applies (w, dL/dw, the
# prefix and da: 13; the 9 gradient terms: 11; their 9 adds into the pixel
# sums); 7 per slot to chain the sums into the 9 feature gradients.
BLEND_BWD_OPS_PER_WALKED = 20
BLEND_BWD_OPS_PER_APPLIED = 33
BLEND_BWD_OPS_PER_SLOT = 7
# K4: one add per element (a reverse scan within each run); K5: one add per
# bf16 half, two per int32 lane.
SEGSUM_OPS_PER_ELEMENT = 1
SEGSUM_PACKED_OPS_PER_LANE = 2
# Dense bf16 tensor-core FLOP/s (NVIDIA data sheet): the rate of P2's passes.
TC_BF16_OPS_PER_S = 989e12
# P1: FP32 operations per element of each mode, from the SASS of
# csrc/probe_transc.cu (scripts/probe_kernel_report.py: the kernel's FADD,
# FMUL, FMNMX, FRND and 2 x FFMA over the 17 elements of its loop and tail).
TRANSC_OPS_PER_ELEMENT = {"mults": 7.4, "exact": 44.7, "exact3": 55.9,
                          "fast3": 40.2}
# P2: FP32 subtractions per element of the bf16 split (the rests x - hi and
# x - hi - mid), by precision.
SPLIT_OPS_PER_ELEMENT = {"default": 0, "high": 1, "highest": 2}

# The bench's configuration, from the package's bench module (the root
# bench.py:85-120 and 246-253): BENCH its render fields with the float32
# stream; DEFAULT its default setting (the packed4 stream, bf16-pair slot
# gradients summed by K5) and EXACT its --exact-grads one (float32 end to
# end, K4), each with the bench's segment sum; JUMBO the realistic scene's
# jumbo ladder.
sys.path.insert(0, HERE)
from gsplat_tpu_torch import bench as _bench  # noqa: E402
from gsplat_tpu_torch import config5_memory as c5  # noqa: E402

NUM_GAUSSIANS = _bench.CARD["num_gaussians"]
BENCH = dict({k: v for k, v in _bench.CARD.items()
              if k not in ("num_gaussians", "impl", "mode", "iters")},
             stream_format="f32")
DEFAULT = _bench.DEFAULT
EXACT = _bench.EXACT
JUMBO = _bench.JUMBO
GOLDEN = dict(width=64, height=64, tile_size=8, max_intersections=1 << 14,
              max_tiles_per_gaussian=64, block_size=8, max_per_tile=512)
TRAIN_LR = 1e-2
SSIM_WEIGHT = 0.2
DC_NOISE = 0.2       # std of the seeded noise on the trained scene's SH DC
TRAIN_ROUNDS = 4     # rounds of the four views: one warm-up, three measured
SERVE_REPS = 4       # repetitions of the four views: one warm-up, three timed
# The hand-made run layouts of K4 and K5 (`segsum_layout`): run lengths, and
# the scan's warp, round and chunk (csrc/segscan.cuh), whose edges the runs
# start and end on.
SEGSUM_LENGTHS = (1, 31, 32, 33, 255, 256, 257, 2047, 2048)
SEGSUM_EDGES = (32, 256, 2048)
# The `cli_train` path: the fit's static capacity (the 1M init padded by a
# quarter); its stream capacity, 1.3x the peak demand of its training views,
# 5,614,342 intersections (the fit's own reading of int_max up to step 80,
# from a run of this path at 7,288,832 on an NVIDIA H100 80GB HBM3,
# 700.00 W), rounded up to a multiple of 2048 as the staged capacity
# rounds; K_max 128 (bench.py --kmax 128): the fit grows splats, and at 64
# some rects passed K_max between steps 160 and 180 (an overflow under
# 'raise'); its steps, and one opacity reset, at step 90, so that the
# held-out PSNR has 90 steps to recover past its first eval (at step 40).
CLI_CAPACITY = 1_250_000
CLI_MAX_INTERSECTIONS = 7_299_072
CLI_KMAX = 128
CLI_STEPS = 180
CLI_RESET_EVERY = 90

# K3's stages in the table of launch counts (ops/cuda/counters.py).
K3_STAGES = ("K3.mask", "K3.compact", "K3.rank", "K3.count", "K3.emit",
             "K3.tier_count", "K3.tier_emit")
# The kernels, in the order of the JSON line: name -> (its names in the
# table of launch counts, summed where the kernel is every stage; source;
# the TPU kernel it replaces).
KERNELS = {
    "cull": (K3_STAGES, "gsplat_tpu_torch/csrc/cull.cu",
             "gsplat_tpu/ops/pallas/cull.py:31"),
    "raster_fwd": (("K1",), "gsplat_tpu_torch/csrc/raster_fwd.cu",
                   "gsplat_tpu/ops/pallas/raster.py:143"),
    "raster_fwd_packed": (("K1.packed",),
                          "gsplat_tpu_torch/csrc/raster_fwd.cu",
                          "gsplat_tpu/ops/pallas/raster.py:143"),
    "raster_bwd": (("K2",), "gsplat_tpu_torch/csrc/raster_bwd.cu",
                   "gsplat_tpu/ops/pallas/raster.py:214"),
    "raster_bwd_packed": (("K2.packed",),
                          "gsplat_tpu_torch/csrc/raster_bwd.cu",
                          "gsplat_tpu/ops/pallas/raster.py:214"),
    "segsum": (("K4",), "gsplat_tpu_torch/csrc/segsum.cu",
               "gsplat_tpu/ops/pallas/segsum.py:41"),
    "segsum_packed": (("K5",), "gsplat_tpu_torch/csrc/segsum_packed.cu",
                      "gsplat_tpu/ops/pallas/segsum.py:86"),
    "probe_transc": (("P1",), "gsplat_tpu_torch/csrc/probe_transc.cu",
                     "scripts/micro_kernel_costs.py:37"),
    "probe_tricumsum": (("P2",), "gsplat_tpu_torch/csrc/probe_tricumsum.cu",
                        "scripts/micro_kernel_costs.py:117"),
    "probe_gather": (("P3",), "gsplat_tpu_torch/csrc/probe_gather.cu",
                     "scripts/micro_kernel_costs.py:156"),
    "probe_coldma": (("P4",), "gsplat_tpu_torch/csrc/probe_coldma.cu",
                     "scripts/micro_kernel_costs.py:213"),
    "feat_fwd": (("K6",), "gsplat_tpu_torch/csrc/feat_fwd.cu",
                 "none: no TPU kernel blends more than the colour"),
    "feat_bwd": (("K7", "K7.chunked"), "gsplat_tpu_torch/csrc/feat_bwd.cu",
                 "none: no TPU kernel blends more than the colour"),
    "project_fwd": (("K8",), "gsplat_tpu_torch/csrc/project.cu",
                    "none: XLA fuses the JAX package's jnp projection"),
    "project_bwd": (("K9",), "gsplat_tpu_torch/csrc/project.cu",
                    "none: XLA fuses the JAX package's jnp projection"),
    "surfel_fwd": (("K10",), "gsplat_tpu_torch/csrc/surfel_fwd.cu",
                   "none: no TPU kernel blends surfels"),
    "surfel_bwd": (("K11",), "gsplat_tpu_torch/csrc/surfel_bwd.cu",
                   "none: no TPU kernel blends surfels"),
    "surfel_project_fwd": (("K12",), "gsplat_tpu_torch/csrc/surfel_project.cu",
                           "none: the JAX package has no surfels"),
    "surfel_project_bwd": (("K13",), "gsplat_tpu_torch/csrc/surfel_project.cu",
                           "none: the JAX package has no surfels"),
}
PROBES = ("probe_transc", "probe_tricumsum", "probe_gather", "probe_coldma")


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn over `iters` calls, timed with CUDA
    events, after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timed_once(fn):
    """(fn(), its milliseconds on the card): one call between CUDA events.
    For the plain versions, which take seconds at the bench shape, so that
    the call that is compared is the one that is timed."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cold_ms(fn, dev, n: int = 10) -> list:
    """Milliseconds of n calls of fn, each between CUDA events right after
    a 512 MB write, which evicts the 50 MB L2 and holds the card while the
    call's launch is queued."""
    import torch

    flush = torch.empty(128 << 20, dtype=torch.float32, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    out = []
    for _ in range(n):
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize(dev)
        out.append(start.elapsed_time(end))
    return out


def psnr(img, ref) -> float:
    mse = float(((img - ref) ** 2).mean())
    peak = max(float(ref.max()), 1.0)
    return 10.0 * np.log10(peak * peak / max(mse, 1e-20))


def bf16_ulp(x):
    """One bf16 ulp at the exponent of |x| (2^-7 of its power of two)."""
    import torch

    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(1e-30))) - 7)


def pair_shares(u_k, u_p):
    """Shares of K2's unpacked bf16-pair gradients `u_k` within tolerance of
    the plain re-walk's `u_p`: (the float32 per-slot tolerance, rtol 2e-3 /
    atol 2e-4, plus one bf16 ulp: the two float32 sums differ by the first
    and each rounds to bf16 by at most half an ulp; one bf16 ulp alone)."""
    import torch

    err = (u_k - u_p).abs()
    ulp = bf16_ulp(torch.maximum(u_k.abs(), u_p.abs()))
    return (float((err <= 2e-4 + 2e-3 * u_p.abs() + ulp).float().mean()),
            float((err <= ulp).float().mean()))


def views(width: int, height: int, device):
    """The default camera and three look_at views near it: shifted 0.1
    right, down, and both, and turned a little the same way. They keep
    the default's up direction and the frame load within the bench's
    capacity (a view of the whole random scene needs about 6.3M
    intersections)."""
    from gsplat_tpu_torch.ops.camera import Camera, look_at

    cams = [Camera.default(width, height, device=device)]
    rows = cams[0].view.cpu().numpy().astype(np.float64)
    right, down, fwd = rows[0, :3], rows[1, :3], rows[2, :3]
    eye = cams[0].cam_pos.cpu().numpy().astype(np.float64)
    for d in (right, down, right + down):
        e = eye + 0.1 * d
        view = look_at(e, e + fwd + 0.05 * d, up=-down)
        cams.append(Camera.create(view, width, height, fx=float(width),
                                  fy=float(height), znear=0.2, zfar=10.0,
                                  device=device))
    return cams


def bound(n_bytes: float, n_ops: float,
          ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """The least time the card needs for the work, in ms, and what sets it:
    n_ops at ops_per_s, FP32 unless said otherwise."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_k1(tag, stream, ranges, c, tile_offset=0):
    """K1 on `stream` (tiles from tile_offset on) against the plain tiled
    walk (of the unpacked stream): (kernel colour, T, plain colour, T,
    per-pixel walk, max abs error, plain ms); exits outside the stated
    tolerance: PSNR >= 60 dB and >= 99.99% of pixels within 1e-4 on image
    and transmittance."""
    from gsplat_tpu_torch.ops import stream16
    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.ops.raster_torch import (
        _raster_tiles,
        _tiles_to_image,
        _tiles_to_scalar_image,
    )

    col_k, tr_k = raster.raster_tiles_cuda(stream, ranges, c, tile_offset)
    plain_in = stream if c.stream_format == "f32" else \
        stream16.unpack_block(stream, c)
    (col_p, tr_p, walk), ms_p = timed_once(
        lambda: _raster_tiles(plain_in, ranges, tile_offset, c))
    img_k, img_p = _tiles_to_image(col_k, c), _tiles_to_image(col_p, c)
    t_k, t_p = _tiles_to_scalar_image(tr_k, c), _tiles_to_scalar_image(tr_p, c)
    err_img = (img_k - img_p).abs()
    err_t = (t_k - t_p).abs()
    p_db = psnr(img_k, img_p)
    within_img = float((err_img.amax(-1) <= 1e-4).float().mean())
    within_t = float((err_t <= 1e-4).float().mean())
    log(f"[K1 {tag}] tile_offset {tile_offset}: {int(ranges[-1])} "
        f"intersections, {int(walk.sum())} pixel-Gaussian pairs walked; PSNR "
        f"{p_db} dB, max abs err image {float(err_img.max())} trans "
        f"{float(err_t.max())}, within 1e-4: image {within_img} trans "
        f"{within_t}")
    if not (p_db >= 60.0 and within_img >= 0.9999 and within_t >= 0.9999):
        raise SystemExit(f"K1 {tag}: kernel outside the stated "
                         "tolerance of the plain version")
    err = max(float(err_img.max()), float(err_t.max()))
    return col_k, tr_k, col_p, tr_p, walk, err, ms_p


def compare_k2(tag, d_k, d_p, applied, total, same, pack):
    """K2's slot gradients d_k against the plain re-walk's d_p (float32, or
    bf16 pairs with pack): each feature row within 1e-3 relative L2 and >=
    99.9% of the walked slots within rtol 2e-3 / atol 2e-4 (plus one bf16
    ulp for pairs), the slots past the stream exactly 0, and `same` (a
    second launch bit-identical). Returns the max abs error; exits
    outside."""
    from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs

    if pack:
        d_p = pack_bf16_pairs(d_p)
        walked_k = unpack_bf16_pairs(d_k[:, :total], 9)
        walked_p = unpack_bf16_pairs(d_p[:, :total], 9)
        err = (walked_k - walked_p).abs()
        within, ulp_share = pair_shares(walked_k, walked_p)
        what = (f"rtol 2e-3 / atol 2e-4 + one bf16 ulp (one bf16 ulp "
                f"alone: {ulp_share})")
    else:
        walked_k, walked_p = d_k[:, :total], d_p[:, :total]
        err = (walked_k - walked_p).abs()
        within = float((err <= 2e-4 + 2e-3 * walked_p.abs()).float().mean())
        what = "rtol 2e-3 / atol 2e-4"
    rel = ((walked_k - walked_p).norm(dim=1)
           / walked_p.norm(dim=1).clamp_min(1e-30)).tolist()
    tail_zero = bool((d_k[:, total:] == 0).all())
    log(f"[K2 {tag}] {int(applied)} pixel-Gaussian pairs applied; "
        f"relative L2 error per feature row {rel}, within {what}: "
        f"{within}, max abs err {float(err.max())}, slots past the "
        f"stream exactly 0: {tail_zero}; a second launch bit-identical: "
        f"{same}")
    if not (max(rel) <= 1e-3 and within >= 0.999 and tail_zero and same):
        raise SystemExit(f"K2 {tag}: kernel outside the stated tolerance "
                         "of the plain version, or not deterministic")
    return float(err.max())


def check_k2(tag, stream, ranges, c, fwd_out, g_col, g_tt, pack,
             tile_offset=0):
    """K2 on `stream` (fed K1's outputs) against the plain re-walk (fed
    the plain forward's), then a second launch that must give the same
    bits: (kernel output, pairs applied, max abs error, plain ms); exits
    outside `compare_k2`'s tolerance."""
    import torch

    from gsplat_tpu_torch.ops import stream16
    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.ops.raster_torch import _raster_tiles_bwd_walk

    col_k, tr_k, col_p, tr_p = fwd_out
    b_k = ((g_col * col_k).sum(1) + g_tt * tr_k).contiguous()
    b_p = (g_col * col_p).sum(1) + g_tt * tr_p
    d_k = raster.raster_bwd_cuda(stream, ranges, g_col, b_k, c, tile_offset,
                                 pack_out=pack)
    same = torch.equal(d_k, raster.raster_bwd_cuda(
        stream, ranges, g_col, b_k, c, tile_offset, pack_out=pack))
    plain_in = stream if c.stream_format == "f32" else \
        stream16.unpack_block(stream, c)
    (d_p, applied), ms_p = timed_once(
        lambda: _raster_tiles_bwd_walk(plain_in, ranges, tile_offset, g_col,
                                       b_p[..., None], c))
    err = compare_k2(tag, d_k, d_p, applied, int(ranges[-1]), same, pack)
    return d_k, int(applied), err, ms_p


def check_k2_inputs(tag, args) -> float:
    """K2 on the arguments a main path gave `raster_bwd_cuda` (kept by
    `first_inputs`) against the plain re-walk on the same upstream
    gradients, with `compare_k2`'s tolerances and a relaunch. Returns the
    max abs error."""
    import torch

    from gsplat_tpu_torch.ops import stream16
    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.ops.raster_torch import _raster_tiles_bwd_walk

    stream, ranges, g_col, b_total, c, tile_offset, pack = args
    d_k = raster.raster_bwd_cuda(*args)
    same = torch.equal(d_k, raster.raster_bwd_cuda(*args))
    plain_in = stream if c.stream_format == "f32" else \
        stream16.unpack_block(stream, c)
    d_p, applied = _raster_tiles_bwd_walk(plain_in, ranges, tile_offset,
                                          g_col, b_total[..., None], c)
    return compare_k2(f"{tag} tile_offset {tile_offset}", d_k, d_p, applied,
                      int(ranges[-1]), same, pack)


def warp_skip_counts(feats, ranges, walk, cfg, rows) -> dict:
    """The (warp, Gaussian) steps of the blend kernels' walk at tile 32 (a
    warp: a 32 x `rows` strip, walking as far as its slowest pixel) on the
    float32 stream `feats`, and how many of them the power floor skips:
    every live pixel's power (as the kernels' pair_power forms it) lies
    below the Gaussian's `raster_torch.power_floor`."""
    import torch

    from gsplat_tpu_torch.ops.raster_torch import power_floor

    t_count = walk.shape[0]
    ts = cfg.tile_size
    dev = walk.device
    lengths = (ranges[1:] - ranges[:-1]).long()
    tile = torch.repeat_interleave(torch.arange(t_count, device=dev), lengths)
    pos = torch.arange(tile.numel(), device=dev) - ranges[:-1].long()[tile]
    f = feats[:, : tile.numel()]
    gxr = f[0] - (tile % cfg.tiles_x * ts).float()
    gyr = f[1] - (tile // cfg.tiles_x * ts).float()
    floor = power_floor(f[8], cfg)
    strips = walk.view(t_count, ts // rows, rows * ts)
    lin = torch.arange(rows * ts, device=dev)
    xs, ys0 = (lin % ts).float(), (lin // ts).float()
    out = dict(steps=0, floor=0)
    for s in range(ts // rows):
        idx = (pos < strips[:, s].amax(-1)[tile]).nonzero()[:, 0]
        out["steps"] += idx.numel()
        for c in idx.split(1 << 15):
            live = pos[c, None] < strips[tile[c], s]
            dx = xs - gxr[c, None]
            dy = ys0 + s * rows - gyr[c, None]
            power = (-0.5 * ((f[2, c, None] * dx) * dx
                             + (f[4, c, None] * dy) * dy)
                     - (f[3, c, None] * dx) * dy)
            near = (live & (power >= floor[c, None])).any(1)
            out["floor"] += int((~near).sum())
    return out


def cull_bound(stage: str, rows: int, kmax: int) -> tuple[float, str]:
    """K3's bound for `stage` on `rows` parameter rows of kmax lanes."""
    per_lane, per_row = CULL_OUT_BYTES[stage]
    n_bytes = rows * (4 * 10 + per_row) + rows * kmax * per_lane
    return bound(n_bytes, rows * kmax * CULL_OPS_PER_LANE
                 + rows * CULL_OPS_PER_ROW)


def emit_bound(rows: int, kmax: int, kept: int) -> tuple[float, str]:
    """K3's emit stage's bound: bytes only (it runs no cull)."""
    return bound(rows * (EMIT_ROW_BYTES + 4 * ((kmax + 31) // 32))
                 + kept * EMIT_SLOT_BYTES, 0)


def check_packed_stages(proj, cfg, tag: str) -> dict:
    """K3's count and emit stages (the 'packed' binning's compaction) on
    proj's rows at cfg's K_max, tile grid and max_intersections, against
    their plain versions, entry for entry: the whole frame with the cull,
    without it, and the lower half of the tile rows as a band. Then the
    kernels' times beside their bounds and the mask stage's (the cull's
    whole walk: what the emit would cost again without the count stage's
    ballots), the plain versions' times, and the launches counted. Exits
    if any entry differs."""
    import torch

    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.cuda import counters, cull

    kmax, ts, tiles_x = cfg.max_tiles_per_gaussian, cfg.tile_size, cfg.tiles_x
    n_tiles, max_slots = cfg.num_tiles, cfg.max_intersections
    depth_bits = binning.depth_bits_for(n_tiles)
    kb = binning._kbits(binning.kmax_eff(cfg))
    with torch.no_grad():
        params = cull.cull_params(proj, cfg)
        depth_q = binning._depth_q(proj.depth, depth_bits)
    rows = params.shape[1]
    half = (cfg.tiles_y // 2) * tiles_x
    before = counters.snapshot()
    out = {"rows": rows, "kmax": kmax, "max_slots": max_slots}
    for name, cull_on, lo, hi in (("frame", True, 0, n_tiles),
                                  ("no_cull", False, 0, n_tiles),
                                  ("band", True, half, n_tiles)):
        count_args = (kmax, ts, cull_on, tiles_x, lo, hi)
        got = cull.cull_count_cuda(params, *count_args)
        want, count_plain_ms = timed_once(
            lambda: cull.cull_count_plain(params, *count_args))
        offsets = (torch.cumsum(got[1], 0) - got[1]).to(torch.int32)
        emit_args = (got[0], offsets, depth_q, kmax, tiles_x, lo, depth_bits,
                     kb, max_slots, binning.SENTINEL_KEY)
        egot = cull.cull_emit_cuda(params, *emit_args)
        ewant, emit_plain_ms = timed_once(
            lambda: cull.cull_emit_plain(params, *emit_args))
        row = dict(kept=int(got[1].sum()),
                   count_differ=[int((g != w).sum())
                                 for g, w in zip(got, want)],
                   emit_differ=[int((g != w).sum())
                                for g, w in zip(egot, ewant)],
                   count_plain_ms=count_plain_ms,
                   emit_plain_ms=emit_plain_ms)
        out[name] = row
        del want, ewant
        if name == "frame":
            out["count_ms"] = cuda_ms(
                lambda: cull.cull_count_cuda(params, *count_args), 20)
            out["emit_ms"] = cuda_ms(
                lambda: cull.cull_emit_cuda(params, *emit_args), 20)
            out["mask_ms"] = cuda_ms(
                lambda: cull.cull_mask_cuda(params, kmax, ts), 20)
            out["count_bound_ms"], out["count_bound_by"] = cull_bound(
                "count", rows, kmax)
            out["emit_bound_ms"], out["emit_bound_by"] = emit_bound(
                rows, kmax, min(row["kept"], max_slots))
        del got, egot
    # 2 calls of each stage per variant, 21 more of the frame's count and
    # emit (cuda_ms warms up once).
    rose = counters.rise(before, counters.snapshot())
    out["launches"] = dict(count=rose.get("K3.count", 0),
                           emit=rose.get("K3.emit", 0))
    log(f"[K3 count/emit {tag}] {json.dumps(out)}")
    if any(any(out[v]["count_differ"]) or any(out[v]["emit_differ"])
           for v in ("frame", "no_cull", "band")):
        raise SystemExit(f"K3 count/emit {tag}: kernel differs from the "
                         "plain version")
    if out["launches"] != {"count": 3 + 21, "emit": 3 + 21}:
        raise SystemExit(f"K3 count/emit {tag}: launches {out['launches']}")
    torch.cuda.empty_cache()
    return out


def check_tier_stages(proj, cfg, tag: str, short: int = 1000) -> dict:
    """K3's tier count and tier emit (the 'tiered' binning's compaction) on
    `binning._tier_rows` of proj at cfg, against their plain versions (every
    tier's lane grid, on the card), entry for entry: the whole frame and the
    lower half of the tile rows as a band, each emitted into a stream of
    cfg.max_intersections slots and into one `short` slots short of the
    candidates. Then the kernels' times beside their bounds (the emit's
    with and without its wrapper's two fills), the plain versions' times,
    and the launches counted. Exits if any entry differs, a stream holds
    other than min(candidates, slots) written slots, or, with jumbo tiers,
    the jumbo rows keep nothing."""
    import torch

    from gsplat_tpu_torch.ops import binning
    from gsplat_tpu_torch.ops.cuda import counters, cull

    n_tiles, max_slots = cfg.num_tiles, cfg.max_intersections
    sentinel = binning.SENTINEL_KEY
    half = (cfg.tiles_y // 2) * cfg.tiles_x
    before = counters.snapshot()
    out = {"max_slots": max_slots}
    for name, lo in (("frame", None), ("band", half)):
        with torch.no_grad():
            rows, _, _ = binning._tier_rows(proj, cfg, n_tiles - (lo or 0),
                                            lo)
        got = cull.cull_tier_count_cuda(rows)
        want, count_plain_ms = timed_once(
            lambda: cull.cull_tier_count_plain(rows))
        offsets = (torch.cumsum(got, 0) - got).to(torch.int32)
        total = int(got.sum())
        base_rows = sum(t[3] for t in rows.tiers if t[0] != cull.TIER_JUMBO)
        row = dict(tiers=len(rows.tiers), rows=got.numel(), kept=total,
                   jumbo_kept=int(got[base_rows:].sum()),
                   count_differ=int((got != want).sum()),
                   count_plain_ms=count_plain_ms, emit={})
        if total <= short:
            raise SystemExit(f"K3 tier count/emit {tag}: {total} candidates "
                             f"in the {name}, too few to cut {short} short")
        for cut, slots in (("full", max_slots), ("short", total - short)):
            egot = cull.cull_tier_emit_cuda(rows, offsets, slots, sentinel)
            ewant, emit_plain_ms = timed_once(
                lambda: cull.cull_tier_emit_plain(rows, offsets, slots,
                                                  sentinel))
            row["emit"][cut] = dict(
                slots=slots, written=int((egot[1] >= 0).sum()),
                want_written=min(total, slots),
                differ=[int((g != w).sum()) for g, w in zip(egot, ewant)],
                plain_ms=emit_plain_ms)
            del egot, ewant
        out[name] = row
        if name == "frame":
            keys, gidk = cull.cull_tier_emit_cuda(rows, offsets, max_slots,
                                                  sentinel)
            out["count_ms"] = cuda_ms(
                lambda: cull.cull_tier_count_cuda(rows), 20)
            out["emit_ms"] = cuda_ms(lambda: cull._tier_launch(
                rows, None, offsets, max_slots, keys, gidk), 20)
            out["emit_fill_ms"] = cuda_ms(lambda: cull.cull_tier_emit_cuda(
                rows, offsets, max_slots, sentinel), 20)
            out["count_bound_ms"], out["count_bound_by"] = bound(
                got.numel() * TIER_COUNT_ROW_BYTES, 0)
            out["emit_bound_ms"], out["emit_bound_by"] = bound(
                got.numel() * TIER_EMIT_ROW_BYTES
                + min(total, max_slots) * EMIT_SLOT_BYTES, 0)
            del keys, gidk
        del rows, got, want, offsets
    # Per variant 1 count and 2 emits (the two streams), the frame's one
    # more for its timing, then its 21 timed counts and 42 timed emits
    # (cuda_ms warms up once).
    rose = counters.rise(before, counters.snapshot())
    out["launches"] = dict(tier_count=rose.get("K3.tier_count", 0),
                           tier_emit=rose.get("K3.tier_emit", 0))
    log(f"[K3 tier count/emit {tag}] {json.dumps(out)}")
    variants = [out[v] for v in ("frame", "band")]
    if any(v["count_differ"] or any(any(e["differ"]) or e["written"]
                                    != e["want_written"]
                                    for e in v["emit"].values())
           for v in variants):
        raise SystemExit(f"K3 tier count/emit {tag}: kernel differs from "
                         "the plain version")
    if cfg.max_tiles_jumbo and not out["frame"]["jumbo_kept"]:
        raise SystemExit(f"K3 tier count/emit {tag}: the jumbo rows keep "
                         "nothing")
    if out["launches"] != {"tier_count": 2 + 21, "tier_emit": 5 + 42}:
        raise SystemExit(f"K3 tier count/emit {tag}: launches "
                         f"{out['launches']}")
    torch.cuda.empty_cache()
    return out


def cull_nan_rows(params, rows_per_field: int = 64):
    """Hand-made K3 rows: the first rows of `params` whose walk bound is
    positive, each of the 10 parameters NaN in its own group of
    `rows_per_field` rows."""
    import torch

    from gsplat_tpu_torch.ops.cuda import cull

    live = (params[cull.R_COUNT] > 0).nonzero()[:, 0]
    out = params[:, live[: cull.NUM_ROWS * rows_per_field]].clone()
    for f in range(cull.NUM_ROWS):
        out[f, f * rows_per_field : (f + 1) * rows_per_field] = float("nan")
    return out.contiguous()


def nan_same(a, b):
    """(NaN at the same places in a and b, a and b with those NaNs zeroed)."""
    import torch

    na, nb = torch.isnan(a), torch.isnan(b)
    return (torch.equal(na, nb), torch.where(na, 0.0, a),
            torch.where(nb, 0.0, b))


def probe_inputs(dev):
    """Phase 10's in-range inputs of P3 and P4 at the TPU script's shapes:
    tab (8, 512) and idx (8, 512) in [0, 512); table (8, 2^20) and cols
    (2048, 128) in [0, 2^20). Seeded torch generators on `dev`."""
    import torch

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    tab = torch.randn((8, 512), generator=gen(0), device=dev)
    idx = torch.randint(0, 512, (8, 512), generator=gen(1), device=dev,
                        dtype=torch.int32)
    table = torch.randn((8, 1 << 20), generator=gen(0), device=dev)
    cols = torch.randint(0, 1 << 20, (2048, 128), generator=gen(1),
                         device=dev, dtype=torch.int32)
    return tab, idx, table, cols


def probe_edge_indices(seed: int, rows: int = 8, cols: int = 512,
                       n: int = 1 << 20, blocks: int = 2048, g: int = 128):
    """(P3's (rows, cols) and P4's (blocks, g) int32 index arrays), numpy,
    holding every edge of the two index rules (ops/cuda/probes.py) in each
    row and each block, at seeded places: for P3 -1, cols, -cols - 1, 10^6,
    -cols, -2^31, 2^31 - 1, 0, cols - 1; for P4 -1, -2, n, n + 5, 10^6, -n,
    -n - 1, -2^31, 2^31 - 1, 0, n - 1. The other entries are uniform in
    [-2 cols, 2 cols) and [-2n, 2n): wrapped, in range and out of range."""
    rng = np.random.default_rng(seed)
    lo, hi = -2 ** 31, 2 ** 31 - 1

    def fill(shape, width, edges):
        out = rng.integers(-2 * width, 2 * width, size=shape)
        edges = np.array(edges, dtype=np.int64)
        for r in range(shape[0]):
            out[r, rng.permutation(shape[1])[:edges.size]] = edges
        return out.astype(np.int32)

    return (fill((rows, cols), cols,
                 (-1, cols, -cols - 1, 10 ** 6, -cols, lo, hi, 0, cols - 1)),
            fill((blocks, g), n,
                 (-1, -2, n, n + 5, 10 ** 6, -n, -n - 1, lo, hi, 0, n - 1)))


def segsum_layout(kmax: int):
    """Hand-made gid-major run layouts for K4 and K5 at `kmax`, in numpy:
    a run of min(33, kmax) slots across a round edge (256) whose middle
    slot is NaN in rows 0-8; for each length of SEGSUM_LENGTHS up to kmax,
    and kmax itself, and each edge of SEGSUM_EDGES, one run that starts on
    a multiple of the edge and one that ends on one, with runs of 1-7 slots
    between; a run of kmax slots across a chunk edge (2048); then a zero
    tail of doubling_depth(kmax) + 1000 slots or one more, one run of id
    2^31 - 1, so that M is not a multiple of 2048. Run ids rise by 1-3
    from run to run. Values N(0, 1) from numpy's generator seeded 0; row 9 is
    zero, so that K5's pair (8|9) has a zero high half as in the pipeline.
    Returns (rows (M,) int32, x (10, M) float32, (first, last + 1) of the
    NaN run)."""
    from gsplat_tpu_torch.ops.cuda.segsum import doubling_depth

    rng = np.random.default_rng(0)
    lengths = []
    pos = 0  # the slots placed so far

    def put(n):
        nonlocal pos
        lengths.append(n)
        pos += n

    def fill_to(target):
        while pos < target:
            put(min(int(rng.integers(1, 8)), target - pos))

    def up(n, edge):
        return -(-n // edge) * edge

    nan_len = min(33, kmax)
    fill_to(SEGSUM_EDGES[1] - nan_len // 3)
    nan_run = (pos, pos + nan_len)
    put(nan_len)
    for n in sorted({n for n in SEGSUM_LENGTHS if n <= kmax} | {kmax}):
        for edge in SEGSUM_EDGES:
            fill_to(up(pos, edge))
            put(n)
            fill_to(up(pos + n, edge) - n)
            put(n)
    chunk = SEGSUM_EDGES[-1]
    fill_to(up(pos + kmax // 2 + 1, chunk) - kmax // 2 - 1)
    put(kmax)
    ids = np.cumsum(rng.integers(1, 4, size=len(lengths)))
    rows = np.repeat(ids, lengths)
    tail = doubling_depth(kmax) + 1000
    tail += (rows.size + tail) % chunk == 0
    rows = np.concatenate([rows, np.full(tail, 2**31 - 1)]).astype(np.int32)
    x = rng.standard_normal((10, rows.size)).astype(np.float32)
    x[9] = 0.0
    x[:, rows.size - tail:] = 0.0
    x[:9, nan_run[0] + nan_len // 2] = np.nan
    return rows, x, nan_run


def check_segsum(tag, x, rows, kmax, nan_run=None, time_it=True) -> dict:
    """K4 (float32 x) or K5 (int32 bf16 pairs) on gid-major `rows` against
    the plain doubling: every value within 1e-6 + 1e-5 times the summed
    span's absolute sum (for K5 or within one bf16 ulp), NaNs at the same
    places in both and, given `nan_run` (first, last + 1), only inside it;
    K5's zero-high (opacity) lanes keep their low halves; a second launch
    bit-identical. Returns the kernel's and the plain version's ms, the
    bound and the max error (with time_it, else the error only); exits on a
    failed check."""
    import torch

    from gsplat_tpu_torch.ops.bf16_pairs import unpack_bf16_pairs
    from gsplat_tpu_torch.ops.cuda import segsum

    packed = x.dtype == torch.int32
    name = "K5" if packed else "K4"
    kernel, plain = ((segsum.segmented_suffix_sum_packed_cuda,
                      segsum.segmented_suffix_sum_packed_plain) if packed else
                     (segsum.segmented_suffix_sum_cuda,
                      segsum.segmented_suffix_sum_plain))
    sum_k = kernel(x, rows, kmax)
    relaunch = torch.equal(sum_k.view(torch.int32),
                           kernel(x, rows, kmax).view(torch.int32))
    sum_p, ms_p = timed_once(lambda: plain(x, rows, kmax))
    if packed:
        f = 2 * x.shape[0]
        vk, vp = unpack_bf16_pairs(sum_k, f), unpack_bf16_pairs(sum_p, f)
        vx = unpack_bf16_pairs(x, f)
    else:
        vk, vp, vx = sum_k, sum_p, x
    same_nan, uk, up = nan_same(vk, vp)
    scale = segsum.segmented_suffix_sum_plain(torch.nan_to_num(vx).abs(),
                                              rows, kmax)
    err = (uk - up).abs()
    tol = 1e-6 + 1e-5 * scale
    if packed:
        tol = torch.maximum(tol, bf16_ulp(torch.maximum(uk.abs(), up.abs())))
    within = bool((err <= tol).all())
    ok = within
    nan_cols = torch.isnan(vk).any(0).nonzero()[:, 0]
    what = ""
    if nan_run is not None:
        inside = bool(((nan_cols >= nan_run[0])
                       & (nan_cols < nan_run[1])).all())
        ok = ok and inside and nan_cols.numel() > 0
        what = (f"; NaN columns {nan_cols.numel()}, all inside the NaN run "
                f"{nan_run}: {inside}")
    if packed:
        # Zero-high lanes with a nonzero low half: float32 denormal bit
        # patterns (all of the opacity pair (8|0) that carries a sum). Their
        # low halves must survive: nonzero in the kernel's output wherever
        # they are in the plain version's (their values are in `ok`).
        low_p, low_k = sum_p & 0xFFFF, sum_k & 0xFFFF
        zero_high = ((sum_p & -65536) == 0) & (low_p != 0)
        low_kept = bool((low_k[zero_high] != 0).all())
        ok = ok and low_kept and bool(zero_high.any())
        what += (f"; {int(zero_high.sum())} nonzero zero-high lanes, their "
                 f"low halves kept: {low_kept}, bit-identical: "
                 f"{float((low_k[zero_high] == low_p[zero_high]).float().mean())}")
    share = float((err <= 1e-6 + 1e-5 * up.abs()).float().mean())
    log(f"[{name} {tag}] {tuple(x.shape)}, depth "
        f"{segsum.doubling_depth(kmax)}: bit-identical to the plain version "
        f"{float((sum_k.view(torch.int32) == sum_p.view(torch.int32)).float().mean())}"
        f", max abs err {float(err.max())}, max err / span abs sum "
        f"{float((err / scale.clamp_min(1e-30)).max())}; within 1e-6 + 1e-5 "
        f"span abs sum{' or one bf16 ulp' if packed else ''}: {within}; "
        f"share within rtol 1e-5 / atol 1e-6 of "
        f"the value {share}; NaNs at the same places: {same_nan}{what}; a "
        f"second launch bit-identical: {relaunch}")
    if not (ok and same_nan and relaunch):
        raise SystemExit(f"{name} {tag}: kernel outside the stated tolerance "
                         "of the plain version, or not deterministic")
    out = dict(max_abs_err=float(err.max()))
    if time_it:
        ms_k = cuda_ms(lambda: kernel(x, rows, kmax), 20)
        n_bytes = (x.numel() + rows.numel() + sum_k.numel()) * 4
        n_ops = x.numel() * (SEGSUM_PACKED_OPS_PER_LANE if packed
                             else SEGSUM_OPS_PER_ELEMENT)
        bound_ms, bound_by = bound(n_bytes, n_ops)
        log(f"[{name} {tag}] kernel {ms_k} ms, plain {ms_p} ms, bound "
            f"{bound_ms} ms ({n_bytes} B, {n_ops} ops, {bound_by})")
        out.update(ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                   bound_by=bound_by)
    return out


def check_segsum_layouts(dev) -> None:
    """K4 (F = 9) and K5 (P = 5) on `segsum_layout` at kmax 2048 and 64
    against their plain versions (`check_segsum`); exits on a failure."""
    import torch

    from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs

    for kmax in (2048, 64):
        rows_np, x_np, nan_run = segsum_layout(kmax)
        rows = torch.from_numpy(rows_np).to(dev)
        x = torch.from_numpy(x_np).to(dev)
        log(f"[segsum layouts kmax {kmax}] M {rows.numel()} (M mod 2048 = "
            f"{rows.numel() % 2048}), {int(torch.unique(rows).numel())} runs")
        for xin in (x[:9].contiguous(), pack_bf16_pairs(x)):
            check_segsum(f"layouts kmax {kmax}", xin, rows, kmax,
                         nan_run=nan_run, time_it=False)


def launch_counts() -> dict:
    """Each kernel's launch count, K3's rank stage (the jumbo grid), count
    and emit stages (the 'packed' binning) and tier count and emit stages
    (the 'tiered' binning) alone as "cull_rank", "cull_count",
    "cull_emit", "cull_tier_count" and "cull_tier_emit", K7's launches that
    walk their channels in passes as "feat_bwd_chunked", and the stage
    marks as "mark"."""
    from gsplat_tpu_torch.ops.cuda import counters

    now = counters.snapshot()
    out = {name: sum(now[n] for n in names)
           for name, (names, _, _) in KERNELS.items()}
    out.update(cull_rank=now["K3.rank"], cull_count=now["K3.count"],
               cull_emit=now["K3.emit"],
               cull_tier_count=now["K3.tier_count"],
               cull_tier_emit=now["K3.tier_emit"],
               feat_bwd_chunked=now["K7.chunked"],
               mark=now["mark"])
    return out


def reset_launch_counts() -> None:
    """Every launch count, the marks and collectives too, to 0."""
    from gsplat_tpu_torch.ops.cuda import counters

    counters.reset()


def make_trainer(scene, cams, cfg, dev, eager=False):
    """The training main path: targets rendered from `scene` at `cams`, a
    trained copy of `scene` whose SH DC carries seeded noise, and its train
    step (the captured `make_train_step`, or with `eager` the same body run
    op by op). Returns (trained scene, targets (V, H, W, 3), step)."""
    import torch

    from gsplat_tpu_torch import render
    from gsplat_tpu_torch.train.loop import (
        make_eager_train_step,
        make_optimizer,
        make_train_step,
    )

    with torch.no_grad():
        targets = torch.stack([render(scene, cam, cfg).image for cam in cams])
    train = noisy_copy(scene, dev)
    opt = make_optimizer(train, TRAIN_LR)
    make = make_eager_train_step if eager else make_train_step
    return train, targets, make(cfg, opt, ssim_weight=SSIM_WEIGHT)


def serve(tag, scene, cams, cfg, card, view0=None):
    """`render` of every view SERVE_REPS times (the first repetition a
    warm-up), each frame checked; returns the median ms per timed frame.
    Records view 0's intersections in view0[tag] when view0 is given."""
    import torch

    from gsplat_tpu_torch import render

    frame_ms = []
    for rep in range(SERVE_REPS):
        for i, cam in enumerate(cams):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render(scene, cam, cfg)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t0) * 1e3
            img = out.image
            ok = (not bool(out.overflow) and int(out.num_intersections) > 0
                  and tuple(img.shape) == (cfg.height, cfg.width, 3)
                  and bool(torch.isfinite(img).all())
                  and float(img.max()) > 0.01)
            if rep == 0 and i == 0 and view0 is not None:
                view0[tag] = int(out.num_intersections)
            if rep == 0:
                log(f"[{tag}] view {i}: {int(out.num_intersections)} "
                    f"intersections, overflow {bool(out.overflow)}, image "
                    f"max {float(img.max())} mean {float(img.mean())}, "
                    f"min T {float(out.transmittance.min())}")
            else:
                frame_ms.append(dt)
            if not ok:
                raise SystemExit(f"{tag}: view {i} failed its checks")
    med = statistics.median(frame_ms)
    log(f"[{tag}] median {med} ms per frame over {len(frame_ms)} frames "
        f"(min {min(frame_ms)}, max {max(frame_ms)}) at {cfg.width}x"
        f"{cfg.height}, {scene.num_gaussians} Gaussians, on {card}")
    return med


def train(tag, scene, cams, cfg, dev, card):
    """TRAIN_ROUNDS rounds of one step per view (the first round a
    warm-up), each step checked; the loss must fall. Returns the median ms
    per measured step."""
    import torch

    trained, targets, step = make_trainer(scene, cams, cfg, dev)
    step_ms, losses = [], []
    for i in range(TRAIN_ROUNDS * len(cams)):
        v = i % len(cams)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, aux, (_, visible) = step(trained, [cams[v]], targets[v : v + 1])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        losses.append(float(loss))
        if i >= len(cams):
            step_ms.append(dt)
        log(f"[{tag}] step {i} view {v}: loss {losses[-1]}, "
            f"{int(aux['num_intersections'])} intersections, overflow "
            f"{bool(aux['overflow'])}, grads finite {bool(aux['grads_finite'])}"
            f", {int(visible.sum())} visible, {dt} ms")
        if bool(aux["overflow"]) or not bool(aux["grads_finite"]) or \
                not np.isfinite(losses[-1]):
            raise SystemExit(f"{tag}: step {i} overflowed or went non-finite")
    n = len(cams)
    rounds = [statistics.mean(losses[r * n : (r + 1) * n])
              for r in range(TRAIN_ROUNDS)]
    log(f"[{tag}] mean loss per round {rounds}")
    if not rounds[-1] < rounds[0]:
        raise SystemExit(f"{tag}: the loss did not fall")
    med = statistics.median(step_ms)
    log(f"[{tag}] median {med} ms per step over {len(step_ms)} steps (min "
        f"{min(step_ms)}, max {max(step_ms)}) at {cfg.width}x{cfg.height}, "
        f"{scene.num_gaussians} Gaussians, on {card}")
    return med


def check_probes(kernels: dict, dev) -> None:
    """The probe kernels P1-P4 against their plain versions on the card at
    the TPU script's shapes (gsplat_tpu_torch/micro_kernel_costs.py); kernel
    ms a CUDA-event mean over 20 launches, plain ms one call. Fills the
    probes' entries of `kernels`; exits on any check that fails."""
    import torch

    from gsplat_tpu_torch import micro_kernel_costs as mkc
    from gsplat_tpu_torch.ops.cuda import probes

    torch.backends.cuda.matmul.allow_tf32 = False  # P2's plain version

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def plain_once(fn):
        """timed_once after one untimed call: the probes' plain versions
        take milliseconds, and a first call's set-up would dominate."""
        fn()
        return timed_once(fn)

    # P1 over (524,288, 1,024): mults and fast3 bit for bit, exact and
    # exact3 within 2 ulp of the plain version's expf / log1pf.
    x = -torch.randn((mkc.BLOCKS * mkc.P // 8, mkc.G * 8), generator=gen(0),
                     device=dev).abs()
    p1_bytes = 2 * x.numel() * 4
    p1 = {}
    for mode in probes.TRANSC_MODES:
        out_k = probes.transc_cuda(x, mode)
        out_p, ms_p = plain_once(lambda: probes.transc_plain(x, mode))
        err = (out_k - out_p).abs()
        differ = int((out_k != out_p).sum())
        if mode in ("mults", "fast3"):
            ok, what = differ == 0, "bit for bit"
        else:
            ok = bool((err <= 2.4e-7 * out_p.abs()).all())
            what = "within 2 ulp (|d| <= 2.4e-7 |plain|)"
        log(f"[P1 {mode}] {x.numel()} elements, {differ} differ from the "
            f"plain version, max abs err {float(err.max())}; {what}: {ok}")
        if not ok:
            raise SystemExit(f"P1 {mode}: kernel outside the stated "
                             "tolerance of the plain version")
        ms_k = cuda_ms(lambda: probes.transc_cuda(x, mode), 20)
        ops = x.numel() * TRANSC_OPS_PER_ELEMENT[mode]
        bound_ms, bound_by = bound(p1_bytes, ops)
        log(f"[P1 {mode}] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms}"
            f" ms ({p1_bytes} B, {ops} ops, {bound_by})")
        p1[mode] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                        bound_by=bound_by, max_abs_err=float(err.max()),
                        differ=differ)
        del out_k, out_p, err
    del x
    kernels["probe_transc"].update(
        max_abs_err=max(v["max_abs_err"] for v in p1.values()),
        **{k: p1["exact3"][k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by")},
        library_ms=None, headline="exact3", by_mode=p1)

    # P2: one 16-row strip and a ragged 37 rows first (the mma fragment
    # layouts, the edge mask), then (4096, 1024, 128).
    tri = probes.make_triangular(mkc.G, device=dev)
    for rows in (16, 37):
        xs = -torch.randn((rows, mkc.G), generator=gen(5),
                          device=dev).abs() * 0.05
        for prec in probes.PASSES:
            e = float((probes.tricumsum_cuda(xs, prec)
                       - probes.tricumsum_plain(xs, tri, prec)).abs().max())
            if not e <= 1e-5:
                raise SystemExit(f"P2 {prec} at {rows} rows: {e} from the "
                                 "plain version")
    log("[P2] 16 and 37 rows: every precision within 1e-5 of the plain "
        "version")
    x = -torch.randn((mkc.BLOCKS, mkc.P, mkc.G), generator=gen(0),
                     device=dev).abs() * 0.05
    ref = torch.cumsum(x[:4], dim=-1)
    scale = torch.cumsum(x[:4].abs(), dim=-1)
    p2_bytes = 2 * x.numel() * 4
    p2 = {}
    for prec, passes in probes.PASSES.items():
        out_k = probes.tricumsum_cuda(x, prec)
        out_p, ms_p = plain_once(
            lambda: probes.tricumsum_plain(x, tri, prec))
        err = float((out_k - out_p).abs().max())
        err_ref = (out_k[:4] - ref).abs()
        if prec == "default":
            ok_ref = bool((err_ref <= 2.0 ** -8 * scale).all())
            what = "within 2^-8 cumsum|x|"
        else:
            ok_ref, what = float(err_ref.max()) <= 1e-5, "within 1e-5"
        log(f"[P2 {prec}] {len(passes)} passes: max abs err {err} from the "
            f"plain version (1e-5 allowed); against the float32 cumsum of "
            f"x[:4] max abs err {float(err_ref.max())}, {what}: {ok_ref}")
        if not (err <= 1e-5 and ok_ref):
            raise SystemExit(f"P2 {prec}: kernel outside the stated tolerance")
        ms_k = cuda_ms(lambda: probes.tricumsum_cuda(x, prec), 20)
        mma_ops = 2 * (x.numel() // mkc.G) * mkc.G * mkc.G * len(passes)
        split_ops = x.numel() * SPLIT_OPS_PER_ELEMENT[prec]
        bound_ms, bound_by = max(bound(p2_bytes, mma_ops, TC_BF16_OPS_PER_S),
                                 bound(p2_bytes, split_ops))
        log(f"[P2 {prec}] kernel {ms_k} ms, plain {ms_p} ms, bound {bound_ms}"
            f" ms ({p2_bytes} B, {mma_ops} tensor-core FLOP, {split_ops} "
            f"FP32 ops, {bound_by})")
        p2[prec] = dict(ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
                        bound_by=bound_by, max_abs_err=err,
                        cumsum_err=float(err_ref.max()))
        del out_k, out_p, err_ref
    lib_ms = cuda_ms(lambda: torch.matmul(x, tri), 20)
    log(f"[P2] library: torch.matmul in float32 (TF32 off) {lib_ms} ms")
    del x, ref, scale
    kernels["probe_tricumsum"].update(
        max_abs_err=max(v["max_abs_err"] for v in p2.values()),
        **{k: p2["highest"][k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by")},
        library_ms=lib_ms, headline="highest", by_precision=p2)

    # P3 at (8, 512) and P4 at (8, 2^20) x (2048, 128): bit for bit.
    tab, idx, table, cols = probe_inputs(dev)
    idx64 = idx.long()
    # P4's least traffic: one 32-byte sector (8 floats of a row) per row for
    # each distinct sector the columns touch.
    sectors = int(torch.unique(cols.long() // 8).numel())
    for name, tag, kernel, plain, library, n_bytes in (
            ("probe_gather", "P3", lambda: probes.lane_gather_cuda(tab, idx),
             lambda: probes.lane_gather_plain(tab, idx),
             lambda: torch.take_along_dim(tab, idx64, dim=-1),
             3 * tab.numel() * 4),
            ("probe_coldma", "P4",
             lambda: probes.column_copy_cuda(table, cols),
             lambda: probes.column_copy_plain(table, cols),
             lambda: table[:, cols],
             sectors * table.shape[0] * 32
             + cols.numel() * (1 + table.shape[0]) * 4)):
        out_k = kernel()
        out_p, ms_p = plain_once(plain)
        same = torch.equal(out_k, out_p)
        log(f"[{tag}] {tuple(out_k.shape)}: bit-identical to the plain "
            f"version: {same}")
        if not same:
            raise SystemExit(f"{tag}: kernel differs from the plain version")
        # Queued behind a spin kernel: these kernels are shorter than a
        # launch from Python, and host-paced events would time the host.
        ms_k = mkc.timeit(dev, kernel, 20)[0]
        lib_ms = mkc.timeit(dev, library, 20)[0]
        bound_ms, bound_by = bound(n_bytes, 0)
        log(f"[{tag}] kernel {ms_k} ms, plain {ms_p} ms, library {lib_ms} ms,"
            f" bound {bound_ms} ms ({n_bytes} B, bytes)")
        kernels[name].update(max_abs_err=0.0, ms=ms_k, plain_ms=ms_p,
                             bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=lib_ms)
    # The launch floor: torch's spin kernel with zero cycles, back to back
    # under the same timer, the least a launch of P3 can take.
    floor_ms = mkc.timeit(dev, lambda: torch.cuda._sleep(0), 20)[0]
    log(f"[P3] launch floor (torch.cuda._sleep(0) back to back) {floor_ms} "
        f"ms; P3 {kernels['probe_gather']['ms']} ms")
    kernels["probe_gather"].update(launch_floor_ms=floor_ms)
    check_probe_edges(dev)
    # P4 with the table out of L2.
    cold = cold_ms(lambda: probes.column_copy_cuda(table, cols), dev)
    log(f"[P4] {sectors} distinct sectors per row; after an L2 flush "
        f"{statistics.median(cold)} ms (median of 10; min {min(cold)}, max "
        f"{max(cold)})")
    kernels["probe_coldma"].update(cold_ms=statistics.median(cold))


def check_probe_edges(dev) -> None:
    """P3 and P4 on probe_edge_indices (every edge of their index rules, in
    range and out of it) against their plain versions, bit for bit with
    NaN at the same places (raw bits compared): at the TPU script's shapes,
    and at shapes that take each kernel's scalar route (C or G not a
    multiple of 4), P3's widest row and a P4 table narrower than its
    indices. Exits on a difference."""
    import torch

    from gsplat_tpu_torch.ops.cuda import probes

    def bits(t):
        return t.view(torch.int32)

    for seed, rows, width, n, blocks, g in ((0, 8, 512, 1 << 20, 2048, 128),
                                            (1, 3, 509, 1000, 5, 127),
                                            (2, 2, probes.GATHER_MAX_COLS,
                                             4096, 3, 132)):
        i3, i4 = probe_edge_indices(seed, rows, width, n, blocks, g)
        gen = torch.Generator(device=dev).manual_seed(seed)
        tab = torch.randn((rows, width), generator=gen, device=dev)
        table = torch.randn((8, n), generator=gen, device=dev)
        idx3 = torch.from_numpy(i3).to(dev)
        idx4 = torch.from_numpy(i4).to(dev)
        k3, p3 = probes.lane_gather_cuda(tab, idx3), probes.lane_gather_plain(
            tab, idx3)
        k4, p4 = probes.column_copy_cuda(table, idx4), \
            probes.column_copy_plain(table, idx4)
        same3, same4 = torch.equal(bits(k3), bits(p3)), torch.equal(
            bits(k4), bits(p4))
        j = idx4.long()
        log(f"[P3/P4 edges] P3 {tuple(tab.shape)}: {int(torch.isnan(k3).sum())}"
            f" NaN, {int(((idx3 < 0) & (idx3 >= -width)).sum())} wrapped; "
            f"bit-identical to the plain version: {same3}. P4 (8, {n}) x "
            f"{tuple(idx4.shape)}: {int(((j < 0) & (j >= -n)).sum())} wrapped,"
            f" {int(((j >= n) | (j < -n)).sum())} clamped, "
            f"{int(torch.isnan(k4).sum())} NaN; bit-identical to the plain "
            f"version: {same4}")
        if not (same3 and same4 and not bool(torch.isnan(k4).any())):
            raise SystemExit("P3/P4 edge indices: kernel differs from the "
                             "plain version")


def check_nan_opacity(gscene, gcam, dev) -> None:
    """K1 and K2 on the golden scene's stream at tile_culling=False (no
    cull drops a Gaussian before the blend) with every 17th slot's opacity
    NaN, float32 and packed4, against the plain walks: K1's image and T
    within 1e-4, K2's gradients within phase 5's tolerances, NaNs at the
    same places. Exits on a difference."""
    import torch

    from gsplat_tpu_torch import RenderConfig
    from gsplat_tpu_torch.ops import binning, stream16
    from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import (
        _raster_tiles,
        _raster_tiles_bwd_walk,
    )

    c32 = RenderConfig(**GOLDEN, tile_culling=False)
    with torch.no_grad():
        proj = project_gaussians(gscene, gcam, c32)
        binned = binning.bin_gaussians(proj, c32)
        feats = binning.gather_features(proj, binned, c32)
    total = int(binned.num_intersections)
    nan_slots = torch.arange(0, total, 17, device=dev)
    feats[binning.FEAT_OPACITY, nan_slots] = float("nan")
    gen = torch.Generator(device=dev).manual_seed(5)
    for fmt in ("f32", "packed4"):
        c = (c32 if fmt == "f32" else
             RenderConfig(**GOLDEN, tile_culling=False, **DEFAULT))
        stream = feats if fmt == "f32" else stream16.pack_stream(feats, c)
        plain_in = feats if fmt == "f32" else stream16.unpack_block(stream, c)
        col_k, tr_k = raster.raster_tiles_cuda(stream, binned.ranges, c)
        col_p, tr_p, _ = _raster_tiles(plain_in, binned.ranges, 0, c)
        same1, *ct = nan_same(torch.cat([col_k.flatten(), tr_k.flatten()]),
                              torch.cat([col_p.flatten(), tr_p.flatten()]))
        err1 = float((ct[0] - ct[1]).abs().max())
        g_col = torch.randn(col_k.shape, generator=gen, device=dev)
        g_tt = torch.randn(tr_k.shape, generator=gen, device=dev)
        pack = fmt != "f32"
        d_k = raster.raster_bwd_cuda(
            stream, binned.ranges, g_col,
            ((g_col * col_k).sum(1) + g_tt * tr_k).contiguous(), c,
            pack_out=pack)
        d_p = _raster_tiles_bwd_walk(
            plain_in, binned.ranges, 0, g_col,
            ((g_col * col_p).sum(1) + g_tt * tr_p)[..., None], c)[0]
        if pack:
            d_k = unpack_bf16_pairs(d_k[:, :total], binning.NUM_FEATURES)
            d_p = unpack_bf16_pairs(pack_bf16_pairs(d_p)[:, :total],
                                    binning.NUM_FEATURES)
        else:
            d_k, d_p = d_k[:, :total], d_p[:, :total]
        same2, u_k, u_p = nan_same(d_k, d_p)
        rel = ((u_k - u_p).norm(dim=1)
               / u_p.norm(dim=1).clamp_min(1e-30)).tolist()
        within = (pair_shares(u_k, u_p)[0] if pack else float(
            ((u_k - u_p).abs() <= 2e-4 + 2e-3 * u_p.abs()).float().mean()))
        log(f"[NaN opacity {fmt}] {total} slots, {nan_slots.numel()} with a "
            f"NaN opacity, tile_culling=False: K1 NaNs at the same places "
            f"{same1}, max abs err image and T {err1}; K2 NaNs at the same "
            f"places {same2} ({int(torch.isnan(d_k).sum())} NaN entries), "
            f"relative L2 per feature row {rel}, within tolerance {within}")
        if not (same1 and err1 <= 1e-4 and same2 and max(rel) <= 1e-3
                and within >= 0.999):
            raise SystemExit(f"NaN opacity {fmt}: K1 or K2 differs from the "
                             "plain version")


class _Tee:
    """A text stream writing to several: `cli.main`'s output is shown and
    kept for the checks."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for st in self.streams:
            st.write(text)
        return len(text)

    def flush(self):
        for st in self.streams:
            st.flush()


def cli_run(argv) -> str:
    """`gsplat_tpu_torch.cli.main(argv)` in this process; its standard
    output, also shown. Fails unless it returns 0; an exception (an
    overflow under --overflow-policy raise) propagates."""
    import io

    from gsplat_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, buf)):
        rc = cli.main(argv)
    if rc != 0:
        raise SystemExit(f"cli {argv[0]}: exit code {rc}")
    return buf.getvalue()


def cli_cfg_flags(cfg: dict) -> list:
    """The `cli` flags (`_common_flags`) that give the render configuration
    `cfg`, which holds a value for each of them. (The command has no flag
    for pallas_block_size or matmul_precision, which select nothing in the
    port.)"""
    flags = []
    for key in ("width", "height", "tile_size", "max_intersections",
                "max_tiles_per_gaussian", "block_size", "max_per_tile",
                "binning", "tier_spec", "gather_backward", "grad_readout",
                "segment_sum", "stream_format"):
        value = cfg[key]
        if key == "tier_spec":
            value = ",".join(f"{k}:{rows}" for k, rows in value)
        flags += ["--" + key.replace("_", "-"), str(value)]
    return flags


def cli_train_argv(out_dir: str) -> list:
    """`cli train` at the bench-default config (BENCH with DEFAULT: 1920x1080,
    tile 32, the tiered ladder, packed4, bf16-pair gradients) with K_max
    CLI_KMAX, on a 1M synthetic target, with a fresh 1M init padded to
    CLI_CAPACITY: 8 training and 2 held-out orbit views, CLI_STEPS steps,
    densification every 20 steps from 20 to 80, an opacity reset every
    CLI_RESET_EVERY steps, a checkpoint every 60, an eval every 40, the
    staged capacity at 1.3x."""
    return [
        "train", "--synthetic-n", str(NUM_GAUSSIANS), "--sh-degree", "3",
        "--seed", "0", "--steps", str(CLI_STEPS), "--views", "8",
        "--holdout-views", "2", "--eval-every", "40",
        "--densify-every", "20", "--densify-from", "20",
        "--densify-until", "80", "--capacity", str(CLI_CAPACITY),
        "--opacity-reset-every", str(CLI_RESET_EVERY),
        "--retighten-capacity", "1.3",
        "--overflow-policy", "raise", "--checkpoint-every", "60",
        "--checkpoint-dir", os.path.join(out_dir, "ckpt"),
        "--metrics-csv", os.path.join(out_dir, "metrics.csv"),
        "--out", os.path.join(out_dir, "trained.ply"),
        "--device", "cuda",
    ] + cli_cfg_flags(dict(BENCH, **DEFAULT,
                           max_intersections=CLI_MAX_INTERSECTIONS,
                           max_tiles_per_gaussian=CLI_KMAX))


def check_cli_train(out_dir: str, card: str, inputs: dict) -> dict:
    """The `cli_train` path: `cli train` (cli_train_argv), then a resume
    from its step-60 checkpoint to the end. Fails unless the last log row's
    loss is below the first's, the last held-out PSNR above the first, a
    densify round split or cloned, the staged capacity tightened, no
    overflow was raised, the saved PLY reloads equal to the trained scene
    (the last step's checkpoint) within rtol 1e-6, and the resume reached
    the last step. Keeps in `inputs` what the first training step gave K3
    and K5 (`first_inputs`). Returns what PERF.md reports."""
    import ast
    import csv

    from gsplat_tpu_torch.io.ply import load_ply
    from gsplat_tpu_torch.ops.cuda import cull, segsum
    from gsplat_tpu_torch.utils import graphs

    os.makedirs(out_dir, exist_ok=True)
    argv = cli_train_argv(out_dir)
    caps = graphs.captures["train_step"]
    t0 = time.perf_counter()
    try:
        with contextlib.ExitStack() as stack:
            # The first training step's cull: the init's CLI_CAPACITY rows
            # (the target's renders before it have NUM_GAUSSIANS).
            stack.enter_context(first_inputs(
                inputs, cull, "cull_compact_cuda",
                lambda params, *_: params.shape[1] == CLI_CAPACITY))
            stack.enter_context(first_inputs(
                inputs, segsum, "segmented_suffix_sum_packed_cuda"))
            text = cli_run(argv)
    except RuntimeError as e:
        raise SystemExit(f"cli_train: the fit raised: {e}")
    wall = time.perf_counter() - t0
    captures = graphs.captures["train_step"] - caps
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    psnrs = [float(r["holdout_psnr"]) for r in rows if r.get("holdout_psnr")]
    densify = [ast.literal_eval(line) for line in text.splitlines()
               if line.startswith("{'num_alive'")]
    tighten = [line for line in text.splitlines()
               if line.startswith("staged capacity: tightening")]
    rebuilds = tighten + [line for line in text.splitlines()
                          if "rebuilding the step at the original" in line]
    ckpt = os.path.join(out_dir, "ckpt", f"ckpt_{CLI_STEPS:06d}.npz")
    ply = load_ply(os.path.join(out_dir, "trained.ply"), device="cpu")
    with np.load(ckpt) as d:
        ply_err = max(
            float(np.max(np.abs(getattr(ply, f).numpy() - d[f"scene.{f}"])
                         / np.maximum(np.abs(d[f"scene.{f}"]), 1e-30)))
            for f in ("means", "log_scales", "quats", "opacity_logits", "sh"))
    ply_ok = ply_err <= 1e-6
    log(f"[cli_train] {wall:.1f} s; log rows {rows}")
    log(f"[cli_train] densify rounds {densify}; {tighten}; PLY against the "
        f"step-{CLI_STEPS} checkpoint: largest relative difference {ply_err};"
        f" {captures} train-step graphs captured, {len(rebuilds)} capacity "
        "rebuilds")

    resume_dir = os.path.join(out_dir, "resume")
    rargv = argv + ["--resume", os.path.join(out_dir, "ckpt",
                                             "ckpt_000060.npz"),
                    "--checkpoint-dir", os.path.join(resume_dir, "ckpt"),
                    "--metrics-csv", os.path.join(resume_dir, "metrics.csv"),
                    "--out", os.path.join(resume_dir, "trained.ply")]
    os.makedirs(resume_dir, exist_ok=True)
    t0 = time.perf_counter()
    try:
        cli_run(rargv)
    except RuntimeError as e:
        raise SystemExit(f"cli_train: the resumed fit raised: {e}")
    rwall = time.perf_counter() - t0
    with open(os.path.join(resume_dir, "metrics.csv")) as f:
        rrows = list(csv.DictReader(f))
    log(f"[cli_train] resume from step 60: {rwall:.1f} s; log rows {rrows}")
    checks = {
        "loss falls": losses[-1] < losses[0],
        "held-out PSNR rises": len(psnrs) > 1 and psnrs[-1] > psnrs[0],
        "a round split or cloned": any(
            d["num_split"] + d["num_clone"] > 0 for d in densify),
        "capacity tightened": bool(tighten),
        "PLY equals the trained scene": ply_ok,
        "resume reached the last step": bool(rrows)
        and int(rrows[-1]["step"]) == CLI_STEPS,
        "captures 1 + the capacity rebuilds": captures == 1 + len(rebuilds),
    }
    log(f"[cli_train] checks {checks} on {card}")
    if not all(checks.values()):
        raise SystemExit(f"cli_train: checks failed: {checks}")
    return {"rows": rows, "densify": densify,
            "tighten": tighten, "captures": captures,
            "wall_s": wall, "resume_rows": rrows, "resume_wall_s": rwall}


@contextlib.contextmanager
def first_inputs(store: dict, module, name: str, want=None):
    """Within the block, `module.name` (a kernel wrapper) keeps in
    store[name] a copy of the arguments of its first call that `want`
    accepts (any, without it), and passes every call on: the inputs that a
    main path gave a kernel, to hold against the plain version after the
    path ran. The copies launch nothing."""
    import torch

    wrapper = getattr(module, name)

    def keep(*args):
        if name not in store and (want is None or want(*args)):
            store[name] = tuple(a.clone() if isinstance(a, torch.Tensor)
                                else a for a in args)
        return wrapper(*args)

    setattr(module, name, keep)
    try:
        yield
    finally:
        setattr(module, name, wrapper)


def check_path_inputs(path: str, inputs: dict, expect: tuple) -> None:
    """The inputs that `path` gave the wrappers named in `expect` (K3's
    stages, K4, K5; kept by `first_inputs`) through the
    kernels again and through the plain versions: K3 0 differing entries in
    every output; K4 and K5 `check_segsum`'s tolerances and a relaunch
    bit-identical.
    Exits on a failure, or where the path never called one of them."""
    from gsplat_tpu_torch.ops.cuda import cull

    missing = [name for name in expect if name not in inputs]
    if missing:
        raise SystemExit(f"{path}: no inputs kept for {missing}")
    for name in expect:
        args = inputs.pop(name)
        if name.startswith("segmented_suffix_sum"):
            x, rows, kmax = args
            check_segsum(f"{path} kmax {kmax}", x, rows, kmax, time_it=False)
            continue
        stage = name[len("cull_"):-len("_cuda")]
        got = getattr(cull, name)(*args)
        want = getattr(cull, f"cull_{stage}_plain")(*args)
        if stage == "mask":
            got, want = (got,), (want,)
        differ = [int((g != w).sum()) for g, w in zip(got, want)]
        kept = int((got[1] >= 0).sum() if stage == "emit" else got[-1].sum())
        log(f"[{path} K3 {stage}] {args[0].shape[1]} rows: {kept} "
            f"{'slots written' if stage == 'emit' else 'lanes kept'}; "
            f"{differ} entries differ from the plain version")
        if any(differ):
            raise SystemExit(f"{path}: K3's {stage} stage differs from the "
                             "plain version on the path's own inputs")


def count_syncs(fn, iters: int):
    """(synchronising CUDA calls per call of fn, {the innermost frame of the
    port's code or the caller's where each happened: count}) over `iters`
    calls, as `torch.cuda.set_sync_debug_mode("warn")` reports them."""
    import collections
    import traceback
    import warnings

    import torch

    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        frames = [f for f in traceback.extract_stack()[:-1]
                  if "gsplat_tpu_torch" in f.filename
                  or f.filename.endswith("chip_smoke.py")]
        f = frames[-1] if frames else traceback.extract_stack()[-2]
        sites[f"{os.path.relpath(f.filename, HERE)}:{f.lineno} {f.name}"] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(iters):
                fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(sites.values()) / iters, dict(sites)


def check_bench(view0: dict, card: str) -> list:
    """The `bench` path: `run_bench` of the 8 runs {fwd, fwd_bwd} x
    {random, realistic} x {default, --exact-grads} of
    `gsplat_tpu_torch.bench.preset` (the realistic runs with the default
    headline's jumbo ladder), iters 10, and the ninth, `--viewer`, with the
    arguments `gsplat_tpu_torch.bench.main` makes for that flag; each with
    the count of synchronising calls per iteration of the call its window
    timed, after the window (`after_window`). Fails unless every run is
    free of overflow and makes no synchronising call, the 8 runs'
    num_intersections equal view 0's of the matching serve path (`view0`;
    the stream format does not change the binning), and the viewer run's
    stay below its capacity and it launched K3's rank stage. Each run
    times a replayed CUDA graph (`render_jit` or `render_loss_and_grad`):
    it must capture one graph of its kind, in its first call."""
    import torch

    from gsplat_tpu_torch.bench import build_kwargs, build_parser, preset
    from gsplat_tpu_torch.ops.cuda import counters
    from gsplat_tpu_torch.utils import bench, graphs

    runs = [(dict(mode=mode, scene=kind, exact_grads=exact),
             dict(preset(kind, exact, mode, "cuda",
                         jumbo=kind == "realistic"), iters=10))
            for mode in ("fwd", "fwd_bwd")
            for kind in ("random", "realistic")
            for exact in (False, True)]
    viewer = build_kwargs(build_parser().parse_args(["--viewer"]),
                          torch.device("cuda", 0))
    runs.append((dict(flags="--viewer"), viewer))
    results = []
    for tag, kw in runs:
        syncs = []
        rank_before = counters.snapshot()["K3.rank"]
        kind = "loss_and_grad" if kw["mode"] == "fwd_bwd" else "render"
        caps = graphs.captures[kind]
        r = bench.run_bench(**kw, after_window=lambda fn: syncs.append(
            count_syncs(fn, kw["iters"])))
        torch.cuda.empty_cache()
        (per_iter, sites), = syncs
        d = r["details"]
        line = dict(tag, value=r["value"], ms_per_iter=d["ms_per_iter"],
                    iters=kw["iters"],
                    num_intersections=d["num_intersections"],
                    overflow=d["overflow"], compile_s=d["compile_s"],
                    syncs_per_iter=per_iter, sync_sites=sites,
                    captures=graphs.captures[kind] - caps,
                    device=d["device"])
        if "flags" in tag:
            line.update(max_intersections=kw["max_intersections"],
                        rank_launches=(counters.snapshot()["K3.rank"]
                                       - rank_before))
            ok = (d["num_intersections"] < kw["max_intersections"]
                  and line["rank_launches"] > 0)
        else:
            line["serve_view0"] = view0[
                "serve packed4 realistic" if tag["scene"] == "realistic"
                else "serve f32"]
            ok = d["num_intersections"] == line["serve_view0"]
        log(f"[bench] {json.dumps(line)}")
        results.append(line)
        if d["overflow"] or per_iter != 0 or not ok or line["captures"] != 1:
            raise SystemExit(f"bench {tag}: overflow, a synchronising call "
                             "in the window, intersections off the serve "
                             "path's view 0 or past the viewer's capacity, "
                             "no K3 rank stage in the viewer run, or not "
                             "one graph captured")
    return results


def cli_render_argv(ply: str, out_dir: str) -> list:
    """The `cli_render` path: `cli render` of `ply` with --viewer-preset
    --pad-bucket --orbit 4, writing PNGs into out_dir."""
    return ["render", ply, "--viewer-preset", "--pad-bucket", "--orbit", "4",
            "--output", os.path.join(out_dir, "{}.png"),
            "--device", "cuda"]


def check_cli_render_pngs(argv) -> None:
    """Each PNG `cli render` wrote must read back equal to `to_uint8` of the
    image rendered again with the same scene, config and camera: the PNG
    round trip, not the kernel (K1 renders both)."""
    import torch

    from gsplat_tpu_torch import cli, render
    from gsplat_tpu_torch.utils.image import read_png, to_uint8

    args = cli.build_parser().parse_args(argv)
    scene, cfg, cams = cli._prepare_render(args)
    for name, cam in cams:
        with torch.no_grad():
            img = render(scene, cam, cfg).image.cpu().numpy()
        png = read_png(args.output.replace("{}", name))
        differ = int((to_uint8(png) != to_uint8(img)).sum())
        log(f"[cli_render] {name}: {differ} PNG values differ from the "
            "rendered image")
        if differ:
            raise SystemExit(f"cli_render: {name}'s PNG differs")


# ---- the multi-device paths (phases 13-17) ----------------------------------
# D ranks share cuda:0 over gloo (NCCL refuses two ranks on one GPU), each a
# spawned process (`multihost.launch`); nccl_world1 runs NCCL at world size
# 1. Their times are those of D ranks time-sharing one card, with gloo
# staging every collective through host memory: times of the path, not
# scaling figures.

# The per-shard stream capacity of the tile-sharded paths is measured
# (`shard_capacity`): the root bench's max(4.1M // D, 4096)
# (bench.py:205-207), 2,050,000 at D = 2, overflows the top band of view 0,
# whose intersections do not split evenly between the bands.
# The Gaussian-sharded path's scene capacity: the 1M scene padded by a
# quarter, so that densification has free slots on each shard.
GAUSS_CAPACITY = 1_250_000
# Steps of the tile-sharded train path (bench default, then --exact-grads),
# of its fit (with the resume from FIT_CKPT_EVERY), and of the
# Gaussian-sharded fit.
SHARDED_STEPS = {"default": 20, "exact": 6}
FIT_STEPS, FIT_CKPT_EVERY, FIT_DENSIFY_AT = 60, 50, 30
GAUSS_FIT_STEPS, GAUSS_DENSIFY_AT = 40, 10
# The Gaussian-sharded path against the single-device one at 1M Gaussians:
# the share of pixels within rtol 1e-3 / atol 1e-4 and of gradient entries
# within rtol 5e-3 / atol 5e-5 (tests/test_gaussian_sharded.py's
# tolerances, which the CPU tests meet on every entry), and the gradients'
# relative L2 error. At 1M Gaussians many fragments of a tile tie in the 21
# depth bits of the 2040-tile grid's key (`tied_pairs`); the merge orders
# tied fragments source by source, the single-device sort by candidate
# position, so the pixels where two tied splats overlap differ (on an H100
# 80GB HBM3 at 700 W: 80-86% of pixels bit-identical, 98.4-98.9% within,
# PSNR 63-69 dB; gradients 99.9992-1.0 within, relative L2 0.06-0.11). The
# tie-order witness (`tie_witness`) runs the same path on a scene whose
# depth keys are all distinct and holds it to the tolerances on every
# entry; at one shard the two orders are one, and nccl_world1 is
# bit-identical.
GAUSS_RENDER_WITHIN = 0.97
GAUSS_GRAD_WITHIN = 0.99999
GAUSS_GRAD_REL_L2 = 0.15
# The witness scene's size: every float32 depth key level of 21 bits in
# [2, 6), one Gaussian each; and its capacity: every witness Gaussian is in
# view (a median of 12 tiles), and the tiers' budgets are shares of the
# capacity, so each shard's rows are padded to half of 131,072. Its log
# scales are random_scene's range moved down by 0.5, so that no Gaussian at
# depth 2 spans more than max_tiles_per_gaussian tiles.
TIE_WITNESS_N = 12_288
TIE_WITNESS_CAPACITY = 131_072
TIE_WITNESS_LOG_SCALES = (-5.0, -3.0)
# The seconds a launch of ranks, or a torchrun of the bench, may take.
LAUNCH_TIMEOUT_S = 420


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def launch_ranks(fn, nprocs: int, *args, backend: str = "gloo",
                 share_card: bool = False,
                 timeout_s: float = LAUNCH_TIMEOUT_S) -> list:
    """fn(rank, *args) on `nprocs` spawned ranks sharing cuda:0, rendezvous
    on a free TCP port (share_card: NCCL ranks, `multihost.share_card_env`);
    every rank's result, or exit on any failure."""
    from gsplat_tpu_torch.parallel import multihost

    out = os.path.join(HERE, "build", "chip_smoke", "ranks", fn.__name__)
    t0 = time.perf_counter()
    try:
        res = multihost.launch(
            fn, nprocs, args, backend=backend, out_dir=out,
            init_method=f"tcp://localhost:{free_port()}", device="cuda:0",
            timeout_s=timeout_s, share_card=share_card)
    except RuntimeError as e:
        raise SystemExit(f"{fn.__name__}: {e}")
    log(f"[{fn.__name__}] {nprocs} ranks on cuda:0 over {backend}: "
        f"{time.perf_counter() - t0:.1f} s wall")
    return res


def shard_capacity(dev, d: int = 2) -> int:
    """The per-shard capacity of the tile-sharded paths: 1.15x the largest
    band's demand over the four views at D bands (the bench's
    suggested_max_intersections rule), rounded up to a multiple of 2048."""
    import torch

    from gsplat_tpu_torch import RenderConfig
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg

    cfg = RenderConfig(**BENCH)
    tiles = local_tile_cfg(cfg, d).num_tiles
    scene = bench_scene(dev)
    demand = []
    with torch.no_grad():
        for cam in views(cfg.width, cfg.height, dev):
            proj = project_gaussians(scene, cam, cfg)
            demand.append([int(bin_gaussians(
                proj, cfg, tile_start=k * tiles,
                num_local_tiles=tiles).num_intersections) for k in range(d)])
    cap = int(max(max(v) for v in demand) * 1.15)
    cap += (-cap) % 2048
    log(f"[shard capacity] intersections per view and band at {d} bands: "
        f"{demand}; per-shard capacity {cap} (the bench's rule gives "
        f"{max(_bench.CARD['max_intersections'] // d, 1 << 12)})")
    return cap


def rank_setup():
    """A rank's start: full float32 in the plain versions, the card."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def bench_scene(dev):
    """The bench's 1M-Gaussian SH-3 random scene, seeded 0."""
    import torch

    from gsplat_tpu_torch import random_scene

    gen = torch.Generator(device=dev).manual_seed(0)
    return random_scene(NUM_GAUSSIANS, sh_degree=3, generator=gen, device=dev)


def noisy_copy(scene, dev):
    """The trained scene of `make_trainer`: a copy whose SH DC carries
    seeded noise."""
    import torch

    from gsplat_tpu_torch import GaussianScene

    train = GaussianScene(**{f.name: getattr(scene, f.name).detach().clone()
                             for f in dataclasses.fields(scene)})
    gen = torch.Generator(device=dev).manual_seed(2)
    train.sh[:, 0, :] += DC_NOISE * torch.randn(
        train.sh[:, 0, :].shape, generator=gen, device=dev)
    return train


def digest(scene) -> str:
    """sha256 of every field's bytes: equal digests, bit-identical scenes."""
    import hashlib

    h = hashlib.sha256()
    for f in dataclasses.fields(scene):
        h.update(getattr(scene, f.name).detach().cpu().numpy().tobytes())
    return h.hexdigest()


def close_share(got, want, rtol: float, atol: float) -> dict:
    """The share of entries of got within atol + rtol |want|, the largest
    |got - want| / (atol + rtol |want|), the max abs difference, the
    relative L2 error, and the share exactly equal."""
    err = (got - want).abs()
    tol = atol + rtol * want.abs()
    return {"within": float((err <= tol).float().mean()),
            "worst": float((err / tol).max()),
            "max_abs": float(err.max()),
            "rel_l2": float((got - want).norm()
                            / want.norm().clamp_min(1e-30)),
            "equal": float((got == want).float().mean())}


def tied_pairs(scene, cam, cfg) -> int:
    """The single-device stream's adjacent fragments of one tile whose
    (tile, depth) keys tie: the pairs whose order a stable sort takes from
    the candidate order."""
    import torch

    from gsplat_tpu_torch.ops.binning import bin_gaussians, pack_tile_depth_key
    from gsplat_tpu_torch.ops.projection import project_gaussians

    with torch.no_grad():
        proj = project_gaussians(scene, cam, cfg)
        b = bin_gaussians(proj, cfg)
    m = int(b.ranges[-1])
    gid = b.sorted_gid[:m]
    keep = gid >= 0
    key = pack_tile_depth_key(b.sorted_tile[:m][keep],
                              proj.depth[gid[keep].long()], cfg.num_tiles)
    return int((key[1:] == key[:-1]).sum())


def tie_witness_scene(cam, cfg, dev, shards: int):
    """TIE_WITNESS_N random Gaussians (seeded 3) moved along `cam`'s view
    axis so that their depths take every depth key level in [2, 6) once, at
    the middle of the level: no two fragments of a tile tie. Padded to
    TIE_WITNESS_CAPACITY with each of `shards` row blocks holding an equal
    share of them at its head."""
    import torch

    from gsplat_tpu_torch import GaussianScene, random_scene
    from gsplat_tpu_torch.ops.binning import depth_bits_for

    gen = torch.Generator(device=dev).manual_seed(3)
    scene = random_scene(TIE_WITNESS_N, sh_degree=3, generator=gen, device=dev,
                         scale_range=TIE_WITNESS_LOG_SCALES)
    shift = 31 - depth_bits_for(cfg.num_tiles)
    level = torch.randperm(TIE_WITNESS_N, generator=gen, device=dev)
    bits = (np.float32(2.0).view(np.int32) + (level << shift)
            + (1 << (shift - 1)))
    z = bits.to(torch.int32).view(torch.float32).double()
    # random_scene's camera-space placement at the new depth, into the world
    # through the inverse of cam's view matrix (not a rotation: the default
    # pose's rows are not unit vectors), in float64 so that the
    # projection's depth stays well inside its level.
    p_cam = torch.stack([scene.means[:, 0].double() / scene.means[:, 2] * z,
                         scene.means[:, 1].double() / scene.means[:, 2] * z,
                         z, torch.ones_like(z)], dim=-1)
    means = p_cam @ torch.linalg.inv(cam.view.double()).T
    scene = dataclasses.replace(scene, means=means[:, :3].float())
    n = TIE_WITNESS_N // shards
    parts = [GaussianScene(**{
        f.name: getattr(scene, f.name)[k * n:(k + 1) * n]
        for f in dataclasses.fields(scene)}).pad_to(
            TIE_WITNESS_CAPACITY // shards) for k in range(shards)]
    return GaussianScene(**{
        f.name: torch.cat([getattr(p, f.name) for p in parts])
        for f in dataclasses.fields(scene)})


def sum_counts(results, key: str) -> dict:
    """Launch counts of one path summed over the ranks."""
    total = {}
    for r in results:
        for k, v in r[key].items():
            total[k] = total.get(k, 0) + v
    return total


def check_counts(path: str, counts: dict, needs) -> dict:
    log(f"[{path}] launches over the ranks {counts}")
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        raise SystemExit(f"{path}: kernels of the path never launched: "
                         f"{missing}")
    return counts


def rank_tile_sharded(rank: int, cap: int) -> dict:
    """Phase 13 on one of 2 ranks (tiles 2): the `tile_sharded` path, serving
    the bench config (f32 and packed4, four views, SERVE_REPS repetitions,
    the first a warm-up) through `render_tile_sharded` at the per-shard
    capacity `cap` (`shard_capacity`); then the `tile_sharded_fit` path: `fit(mesh=...)`
    of a noisy-DC copy of the scene padded to GAUSS_CAPACITY, FIT_STEPS
    steps with one densification round and a checkpoint from the primary
    rank, and a resume from it. Checks after the paths: this rank's K3
    compact inputs against the plain version; rank 1's K1 at its tile
    offset against the plain walk, each format; rank 0's gathered images
    against the single-device render."""
    import contextlib as ctx
    import io

    import torch

    from gsplat_tpu_torch import RenderConfig, render
    from gsplat_tpu_torch.ops.cuda import cull, raster
    from gsplat_tpu_torch.parallel.sharding import (
        local_tile_cfg,
        make_mesh,
        render_tile_sharded,
    )
    from gsplat_tpu_torch.train.loop import fit

    dev = rank_setup()
    mesh = make_mesh({"tiles": 2}, dev)
    scene = bench_scene(dev)
    cfgs = {"f32": RenderConfig(**dict(BENCH, max_intersections=cap)),
            "packed4": RenderConfig(**dict(BENCH, **DEFAULT,
                                           max_intersections=cap))}
    cams = views(cfgs["f32"].width, cfgs["f32"].height, dev)
    offset = rank * local_tile_cfg(cfgs["f32"], 2).num_tiles
    out = {"rank": rank, "tile_offset": offset, "ms": {}}
    inputs, k1_inputs, frames = {}, {}, {}
    reset_launch_counts()
    with first_inputs(inputs, cull, "cull_compact_cuda"):
        for fmt, cfg in cfgs.items():
            k1_inputs[fmt] = {}
            ms = []
            with first_inputs(k1_inputs[fmt], raster, "raster_tiles_cuda",
                              want=lambda *a: a[3] == offset):
                for rep in range(SERVE_REPS):
                    for i, cam in enumerate(cams):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        img, trans, ovf = render_tile_sharded(scene, cam, cfg,
                                                              mesh)
                        torch.cuda.synchronize()
                        dt = (time.perf_counter() - t0) * 1e3
                        if bool(ovf) or not bool(torch.isfinite(img).all()):
                            raise SystemExit(f"tile_sharded {fmt} view {i}: "
                                             "overflow or non-finite")
                        if rep == 0 and rank == 0:
                            frames[fmt, i] = (img, trans)
                        elif rep:
                            ms.append(dt)
            out["ms"][fmt] = statistics.median(ms)
    out["serve"] = launch_counts()
    check_path_inputs(f"tile_sharded rank {rank}", inputs,
                      ("cull_compact_cuda",))
    if rank == 1:
        for fmt in cfgs:
            s, r, c, off = k1_inputs[fmt]["raster_tiles_cuda"]
            out[f"k1_{fmt}_err"] = check_k1(f"tile_sharded {fmt} rank 1", s,
                                            r, c, off)[5]
    if rank == 0:
        out["vs_single"] = {}
        for (fmt, i), (img, trans) in frames.items():
            single = dataclasses.replace(
                cfgs[fmt], max_intersections=_bench.CARD["max_intersections"])
            with torch.no_grad():
                ref = render(scene, cams[i], single)
            c_img = close_share(img, ref.image, 1e-4, 1e-5)
            c_t = close_share(trans, ref.transmittance, 1e-4, 1e-6)
            db = psnr(img, ref.image)
            out["vs_single"][f"{fmt} view {i}"] = dict(
                image=c_img, trans=c_t, psnr=db)
            log(f"[tile_sharded] {fmt} view {i} against the single-device "
                f"render: image {c_img}, T {c_t}, PSNR {db} dB")
        del frames
        bad = [k for k, v in out["vs_single"].items()
               if not (v["image"]["within"] == 1.0
                       and v["trans"]["within"] == 1.0)]
        if bad:
            raise SystemExit(f"tile_sharded {bad}: outside the stated "
                             "tolerance of the single-device render")

    # The tile_sharded_fit path.
    cfg = cfgs["packed4"]
    with torch.no_grad():
        targets = torch.stack([
            render(scene, cam, dataclasses.replace(
                cfg, max_intersections=_bench.CARD["max_intersections"])).image
            for cam in cams])
    init = noisy_copy(scene, dev).pad_to(GAUSS_CAPACITY)
    del scene
    ckpt = os.path.join(HERE, "build", "chip_smoke", "fit_ckpt")
    printed = io.StringIO()
    kw = dict(steps=FIT_STEPS, lr=TRAIN_LR, ssim_weight=SSIM_WEIGHT,
              log_every=5, densify_every=FIT_DENSIFY_AT,
              densify_from=FIT_DENSIFY_AT, densify_until=FIT_DENSIFY_AT,
              checkpoint_every=FIT_CKPT_EVERY, checkpoint_dir=ckpt,
              overflow_policy="raise", mesh=mesh)
    reset_launch_counts()
    t0 = time.perf_counter()
    with ctx.redirect_stdout(printed):
        trained, metrics = fit(init, cams, targets, cfg, **kw)
        resumed, metrics2 = fit(init, cams, targets, cfg, resume=os.path.join(
            ckpt, f"ckpt_{FIT_CKPT_EVERY:06d}.npz"), **kw)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["fit"] = launch_counts()
    out["fit_metrics"], out["resume_metrics"] = metrics, metrics2
    out["printed"] = printed.getvalue()
    out["digests"] = [digest(trained), digest(resumed)]
    out["ckpts"] = sorted(os.listdir(ckpt))
    return out


def rank_tile_sharded_train(rank: int, cap: int) -> dict:
    """Phase 14 on one of 4 ranks (data 2 x tiles 2): the
    `tile_sharded_train` path, the sharded step at the bench default
    (packed4, bf16 pairs, K5) for SHARDED_STEPS steps, then --exact-grads
    (float32, K4), two views a step (one per data shard), L1 + 0.2 DSSIM
    from a noisy-DC copy. Rank 0 holds the first step's loss and gradients
    against `make_train_step` on the same two views, every entry within
    the stated tolerance; rank 3 keeps the inputs of its first step's K3
    compact stage, K2 (at its tile offset) and K5 (default) or K4 (exact)
    in each run, and holds them against the plain versions after the
    path."""
    import torch

    from gsplat_tpu_torch import RenderConfig, render
    from gsplat_tpu_torch.ops.cuda import cull, raster, segsum
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg, make_mesh
    from gsplat_tpu_torch.parallel.train_step import (
        make_sharded_train_step,
        shard_batch,
    )
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_optimizer

    dev = rank_setup()
    mesh = make_mesh({"data": 2, "tiles": 2}, dev)
    scene = bench_scene(dev)
    out = {"rank": rank, "losses": {}, "ms": {}, "first": {}, "digests": {}}
    kept = {}
    segsums = {"default": "segmented_suffix_sum_packed_cuda",
               "exact": "segmented_suffix_sum_cuda"}
    # Targets and rank 0's single-device first steps, before the path.
    setups = {}
    for name, extra, rtol, atol in (("default", DEFAULT, 5e-3, 5e-5),
                                    ("exact", EXACT, 2e-3, 2e-6)):
        full = RenderConfig(**dict(BENCH, **extra))
        cfg = dataclasses.replace(full, max_intersections=cap)
        cams = views(cfg.width, cfg.height, dev)
        with torch.no_grad():
            targets = torch.stack([render(scene, c, full).image for c in cams])
        padded = torch.nn.functional.pad(
            targets, (0, 0, 0, cfg.padded_width - cfg.width, 0,
                      cfg.padded_height - cfg.height))
        ref = None
        if rank == 0:
            single = noisy_copy(scene, dev)
            step_r = make_eager_train_step(
                full, make_optimizer(single, TRAIN_LR),
                ssim_weight=SSIM_WEIGHT)
            loss_r, _, _ = step_r(single, cams[:2], targets[:2])
            ref = (float(loss_r), {f: getattr(single, f).grad.clone()
                                   for f in SCENE_FIELDS})
            del single, step_r
        setups[name] = (cfg, cams, padded, ref, rtol, atol)
        del targets
    reset_launch_counts()
    for name, (cfg, cams, padded, ref, rtol, atol) in setups.items():
        offset = mesh.index("tiles") * local_tile_cfg(cfg, 2).num_tiles
        trained = noisy_copy(scene, dev)
        opt = make_optimizer(trained, TRAIN_LR)
        step = make_sharded_train_step(cfg, mesh, opt, ssim_weight=SSIM_WEIGHT)
        kept[name] = {}
        losses, ms = [], []
        for i in range(SHARDED_STEPS[name]):
            a = 2 * i % len(cams)
            cams_l, bands = shard_batch([cams[a], cams[a + 1]],
                                        padded[a:a + 2], mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.ExitStack() as keep:
                if rank == 3 and i == 0:
                    keep.enter_context(first_inputs(
                        kept[name], raster, "raster_bwd_cuda",
                        want=lambda *x: x[5] == offset))
                    keep.enter_context(first_inputs(
                        kept[name], cull, "cull_compact_cuda"))
                    keep.enter_context(first_inputs(
                        kept[name], segsum, segsums[name]))
                loss, aux, _ = step(trained, cams_l, bands)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(loss))
            if bool(aux["overflow"]) or not bool(aux["grads_finite"]) or \
                    not np.isfinite(losses[-1]):
                raise SystemExit(f"tile_sharded_train {name}: step {i} "
                                 "overflowed or went non-finite")
            if i == 0 and ref is not None:
                out["first"][name] = dict(
                    loss=losses[0], single_loss=ref[0],
                    rel=abs(losses[0] - ref[0]) / abs(ref[0]),
                    grads={f: close_share(getattr(trained, f).grad, g,
                                          rtol, atol)
                           for f, g in ref[1].items()},
                    rtol=rtol, atol=atol)
        out["losses"][name], out["ms"][name] = losses, ms[1:]
        out["digests"][name] = digest(trained)
        del trained, opt, step
    out["train"] = launch_counts()
    for name, first in out["first"].items():
        log(f"[tile_sharded_train {name}] first step loss {first['loss']} "
            f"single-device {first['single_loss']} (rel {first['rel']}); "
            f"gradients against the single-device step, rtol "
            f"{first['rtol']} / atol {first['atol']}: {first['grads']}")
        if first["rel"] > 1e-5 or any(g["within"] < 1.0
                                      for g in first["grads"].values()):
            raise SystemExit(f"tile_sharded_train {name}: the first step "
                             "differs from the single-device step")
    if rank == 3:
        for name, inputs in kept.items():
            tag = f"tile_sharded_train {name} rank 3"
            if "raster_bwd_cuda" not in inputs:
                raise SystemExit(f"{tag}: K2 never ran at the tile offset")
            out[f"k2_{name}_err"] = check_k2_inputs(
                tag, inputs.pop("raster_bwd_cuda"))
            check_path_inputs(tag, inputs, ("cull_compact_cuda",
                                            segsums[name]))
    return out


def rank_gaussian_sharded(rank: int) -> dict:
    """Phase 15 on one of 2 ranks (gauss 2): the `gaussian_sharded` path at
    the bench's config-5 settings (tiered, packed16 wire, fragment_format
    'bf16') with the 1M scene padded to GAUSS_CAPACITY: the render of the
    four views, one train step, then `fit_gaussian_sharded` for
    GAUSS_FIT_STEPS steps with one densification round and per-shard
    checkpoints. fragment_occupancy comes first; after the path, the
    checkpoint reloaded bit for bit, the kernels on the path's own inputs
    (every rank's first K3 compact stage; rank 1's first K1 and K2 at its
    tile offset, on the merged packed16 stream, and its step's K5 on the
    received blocks) against the plain versions, the step's gradients
    against the matching rows of the single-device step, the render
    against the single-device packed16 render (rank 0), and the tie-order
    witness (`gaussian_tie_witness`)."""
    import torch

    from gsplat_tpu_torch import RenderConfig, render
    from gsplat_tpu_torch.ops.cuda import cull, raster, segsum
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        exchange_bytes,
        fragment_occupancy,
        render_gaussian_sharded,
        shard_scene,
    )
    from gsplat_tpu_torch.parallel.gaussian_train import (
        fit_gaussian_sharded,
        load_sharded_checkpoint,
        make_gaussian_sharded_train_step,
        shard_train_state,
    )
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg, make_mesh
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_optimizer
    from gsplat_tpu_torch.utils.checkpoint import checkpoint_arrays

    dev = rank_setup()
    d = 2
    mesh = make_mesh({"gauss": d}, dev)
    cfg = RenderConfig(**dict(BENCH, **dict(DEFAULT, stream_format="packed16",
                                            fragment_format="bf16")))
    scene = bench_scene(dev).pad_to(GAUSS_CAPACITY)
    cams = views(cfg.width, cfg.height, dev)
    # The capacity report first, at the bench's per-dest capacity
    # (max_intersections // D); the path runs at its suggestion, the
    # largest (source, destination) segment of the views with 15% room.
    occ = [fragment_occupancy(scene, c, cfg, d) for c in cams]
    cap = max(o["suggested_per_dest_capacity"] for o in occ)
    out = {"rank": rank, "wire": exchange_bytes(cfg, d, cap),
           "per_dest_capacity": cap, "occupancy": occ[0],
           "tile_offset": rank * local_tile_cfg(cfg, d).num_tiles}
    log(f"[gaussian_sharded rank {rank}] fragment occupancy at the bench's "
        f"per-dest capacity {occ[0]['per_dest_capacity']}: max segment per "
        f"view {[o['max_segment'] for o in occ]}, view 0 {occ[0]}; the path "
        f"runs at {cap}")
    if any(o["suggested_per_dest_capacity"] < o["max_segment"] or
           o["max_segment"] > cap for o in occ):
        raise SystemExit(f"gaussian_sharded: occupancy {occ}")
    with torch.no_grad():
        targets = torch.stack([render(scene, c, cfg).image for c in cams])
    lcfg = local_tile_cfg(cfg, d)
    band = torch.nn.functional.pad(
        targets, (0, 0, 0, cfg.padded_width - cfg.width, 0,
                  cfg.padded_height - cfg.height))[
        :, rank * lcfg.height:(rank + 1) * lcfg.height]
    local = shard_scene(scene, mesh)
    trained = noisy_copy(scene, dev)
    train_l, opt = shard_train_state(trained, mesh, lr=TRAIN_LR)
    step = make_gaussian_sharded_train_step(cfg, mesh, opt, GAUSS_CAPACITY,
                                            ssim_weight=SSIM_WEIGHT,
                                            per_dest_capacity=cap)
    ckpt = os.path.join(HERE, "build", "chip_smoke", "gauss_ckpt")
    offset = rank * lcfg.num_tiles
    frames, ms, inputs = [], [], {}
    reset_launch_counts()
    with contextlib.ExitStack() as keep:
        keep.enter_context(first_inputs(inputs, cull, "cull_compact_cuda"))
        if rank == 1:
            keep.enter_context(first_inputs(
                inputs, raster, "raster_tiles_cuda",
                want=lambda *a: a[3] == offset))
            keep.enter_context(first_inputs(
                inputs, raster, "raster_bwd_cuda",
                want=lambda *a: a[5] == offset))
            keep.enter_context(first_inputs(
                inputs, segsum, "segmented_suffix_sum_packed_cuda"))
        for rep in range(2):
            for i, cam in enumerate(cams):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    img, trans, ovf = render_gaussian_sharded(
                        local, cam, cfg, mesh, per_dest_capacity=cap)
                torch.cuda.synchronize()
                if rep:
                    ms.append((time.perf_counter() - t0) * 1e3)
                if bool(ovf) or not bool(torch.isfinite(img).all()):
                    raise SystemExit(f"gaussian_sharded view {i}: overflow "
                                     "or non-finite")
                if rep == 0 and rank == 0:
                    frames.append((img, trans))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m, (_, visible) = step(train_l, cams[:1], band[:1])
        torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    grads = {f: getattr(train_l, f).grad.clone() for f in SCENE_FIELDS}
    t0 = time.perf_counter()
    fitted, metrics = fit_gaussian_sharded(
        noisy_copy(scene, dev), cams, targets, cfg, mesh,
        steps=GAUSS_FIT_STEPS, lr=TRAIN_LR, ssim_weight=SSIM_WEIGHT,
        log_every=1, densify_every=GAUSS_DENSIFY_AT,
        densify_until=GAUSS_DENSIFY_AT, per_dest_capacity=cap,
        checkpoint_path=ckpt,
        checkpoint_every=GAUSS_FIT_STEPS)
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["gauss"] = launch_counts()
    out["frame_ms"], out["metrics"] = ms, metrics
    out["step_loss"] = float(m["loss"])
    losses = [row["loss"] for row in metrics]
    if bool(m["overflow"]) or not (statistics.mean(losses[-4:])
                                   < statistics.mean(losses[:4])):
        raise SystemExit(f"gaussian_sharded: step overflow {m['overflow']} or "
                         f"the fit's loss did not fall: {metrics}")

    # The checkpoint, reloaded into a fresh shard: the fit's scene bit for
    # bit, and every array of this rank's file.
    fresh, fresh_opt = shard_train_state(scene, mesh, lr=TRAIN_LR)
    step_at = load_sharded_checkpoint(ckpt, fresh, fresh_opt, mesh)
    with np.load(os.path.join(ckpt, f"shard_{rank:05d}.npz")) as z:
        saved = {n: z[n] for n in z.files}
    got = checkpoint_arrays(fresh, fresh_opt, step_at)
    out["ckpt_ok"] = bool(
        step_at == GAUSS_FIT_STEPS and digest(fresh) == digest(fitted)
        and all(np.array_equal(got[n], a) for n, a in saved.items()))
    log(f"[gaussian_sharded rank {rank}] per-shard checkpoint at step "
        f"{step_at} reloaded bit for bit: {out['ckpt_ok']}")
    failed = [] if out["ckpt_ok"] else ["the per-shard checkpoint"]

    # The kernels on the path's own inputs.
    tag = f"gaussian_sharded rank {rank}"
    if rank == 1:
        if not {"raster_tiles_cuda", "raster_bwd_cuda"} <= inputs.keys():
            raise SystemExit(f"{tag}: K1 or K2 never ran at the tile offset")
        s16, r16, c16, off = inputs.pop("raster_tiles_cuda")
        out["k1_err"] = check_k1(f"{tag} merged packed16", s16, r16, c16,
                                 off)[5]
        del s16, r16
        out["k2_err"] = check_k2_inputs(f"{tag} merged packed16",
                                        inputs.pop("raster_bwd_cuda"))
    check_path_inputs(tag, inputs, ("cull_compact_cuda",) + (
        ("segmented_suffix_sum_packed_cuda",) if rank == 1 else ()))

    # The step's shard-local gradients against the single-device step.
    ref = noisy_copy(scene, dev)
    step_r = make_eager_train_step(cfg, make_optimizer(ref, TRAIN_LR),
                                   ssim_weight=SSIM_WEIGHT)
    loss_r, _, (_, vis_r) = step_r(ref, cams[:1], targets[:1])
    n = GAUSS_CAPACITY // d
    rows = slice(rank * n, (rank + 1) * n)
    out["step_vs_single"] = {f: close_share(grads[f], getattr(ref, f).grad[rows],
                                            5e-3, 5e-5) for f in SCENE_FIELDS}
    out["visible_equal"] = bool(torch.equal(visible, vis_r[rows]))
    out["single_loss"] = float(loss_r)
    log(f"[gaussian_sharded rank {rank}] step loss {out['step_loss']} "
        f"single-device {float(loss_r)}; gradients against the single-device "
        f"rows, rtol 5e-3 / atol 5e-5: {out['step_vs_single']}; visible "
        f"equal {out['visible_equal']}")
    if not out["visible_equal"] or any(
            g["within"] < GAUSS_GRAD_WITHIN or g["rel_l2"] > GAUSS_GRAD_REL_L2
            for g in out["step_vs_single"].values()):
        failed.append("the step's gradients or visibility")
    del ref, step_r
    if rank == 0:
        out["tied_pairs"] = tied_pairs(scene, cams[0], cfg)
        log(f"[gaussian_sharded] view 0's single-device stream: "
            f"{out['tied_pairs']} adjacent fragment pairs of one tile with "
            "tied keys")
        out["vs_single"] = []
        for i, (img, trans) in enumerate(frames):
            with torch.no_grad():
                want = render(scene, cams[i], cfg)
            c_img = close_share(img, want.image, 1e-3, 1e-4)
            db = psnr(img, want.image)
            out["vs_single"].append(dict(image=c_img, psnr=db))
            log(f"[gaussian_sharded] view {i} against the single-device "
                f"packed16 render: {c_img}, PSNR {db} dB")
            if not (c_img["within"] >= GAUSS_RENDER_WITHIN and db >= 60.0):
                failed.append(f"view {i}'s render")
    del frames, scene, local, train_l, opt, step, fitted, fresh, fresh_opt
    out["witness"] = gaussian_tie_witness(rank, mesh, cams[0], cfg, dev)
    if not out["witness"]["ok"]:
        failed.append("the tie-order witness")
    if failed:
        raise SystemExit(f"gaussian_sharded rank {rank}: {failed} outside "
                         "the stated tolerance")
    return out


def gaussian_tie_witness(rank: int, mesh, cam, cfg, dev) -> dict:
    """The tie-order witness of the gaussian_sharded path, on every rank:
    `tie_witness_scene` (no tied keys in the single-device stream, checked)
    rendered through `render_gaussian_sharded` and one sharded train step
    from its noisy-DC copy, against the single-device packed16 render (rank
    0) and step (each rank its rows): every pixel within rtol 1e-3 / atol
    1e-4 and every gradient entry within rtol 5e-3 / atol 5e-5
    (tests/test_gaussian_sharded.py's tolerances), visible equal."""
    import torch

    from gsplat_tpu_torch import render
    from gsplat_tpu_torch.parallel.gaussian_sharded import (
        render_gaussian_sharded,
        shard_scene,
    )
    from gsplat_tpu_torch.parallel.gaussian_train import (
        make_gaussian_sharded_train_step,
        shard_train_state,
    )
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_optimizer

    d = mesh.size_of("gauss")
    scene = tie_witness_scene(cam, cfg, dev, d)
    ties = tied_pairs(scene, cam, cfg)
    with torch.no_grad():
        want = render(scene, cam, cfg)
        img, trans, ovf = render_gaussian_sharded(shard_scene(scene, mesh),
                                                  cam, cfg, mesh)
    lcfg = local_tile_cfg(cfg, d)
    band = torch.nn.functional.pad(
        want.image, (0, 0, 0, cfg.padded_width - cfg.width, 0,
                     cfg.padded_height - cfg.height))[
        rank * lcfg.height:(rank + 1) * lcfg.height][None]
    local, opt = shard_train_state(noisy_copy(scene, dev), mesh, lr=TRAIN_LR)
    step = make_gaussian_sharded_train_step(cfg, mesh, opt,
                                            TIE_WITNESS_CAPACITY,
                                            ssim_weight=SSIM_WEIGHT)
    m, (_, visible) = step(local, [cam], band)
    ref = noisy_copy(scene, dev)
    step_r = make_eager_train_step(cfg, make_optimizer(ref, TRAIN_LR),
                                   ssim_weight=SSIM_WEIGHT)
    loss_r, _, (_, vis_r) = step_r(ref, [cam], want.image[None])
    n = TIE_WITNESS_CAPACITY // d
    rows = slice(rank * n, (rank + 1) * n)
    grads = {f: close_share(getattr(local, f).grad, getattr(ref, f).grad[rows],
                            5e-3, 5e-5) for f in SCENE_FIELDS}
    out = dict(tied_pairs=ties, overflow=bool(ovf) or bool(m["overflow"])
               or bool(want.overflow),
               loss=float(m["loss"]), single_loss=float(loss_r), grads=grads,
               visible_equal=bool(torch.equal(visible, vis_r[rows])),
               intersections=int(want.num_intersections))
    if rank == 0:
        out["image"] = close_share(img, want.image, 1e-3, 1e-4)
        out["trans"] = close_share(trans, want.transmittance, 1e-3, 1e-4)
    out["ok"] = bool(
        ties == 0 and not out["overflow"] and out["visible_equal"]
        and all(g["within"] == 1.0 for g in grads.values())
        and all(out[k]["within"] == 1.0 for k in ("image", "trans")
                if k in out))
    log(f"[gaussian_sharded tie witness rank {rank}] {TIE_WITNESS_N} "
        f"Gaussians, {out['intersections']} intersections, {ties} tied "
        f"pairs; {json.dumps({k: v for k, v in out.items() if k != 'ok'})}"
        f"; every entry within the stated tolerance: {out['ok']}")
    return out


def rank_nccl_world1(rank: int) -> dict:
    """Phase 17, one rank on NCCL: one tile-sharded frame (tiles 1) and one
    Gaussian-sharded train step (gauss 1) at the bench settings, against
    the single-device port: the frame, the step's loss, gradients and
    visibility bit for bit."""
    import torch

    from gsplat_tpu_torch import RenderConfig, render
    from gsplat_tpu_torch.parallel.gaussian_train import (
        make_gaussian_sharded_train_step,
        shard_train_state,
    )
    from gsplat_tpu_torch.parallel.sharding import make_mesh, render_tile_sharded
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_optimizer

    dev = rank_setup()
    backend = torch.distributed.get_backend()
    tiles, gauss = make_mesh({"tiles": 1}, dev), make_mesh({"gauss": 1}, dev)
    scene = bench_scene(dev)
    cfg = RenderConfig(**dict(BENCH, **DEFAULT))
    cam = views(cfg.width, cfg.height, dev)[0]
    g16 = dataclasses.replace(cfg, stream_format="packed16",
                              fragment_format="bf16")
    with torch.no_grad():
        target = render(scene, cam, g16).image
    reset_launch_counts()
    with torch.no_grad():
        img, trans, ovf = render_tile_sharded(scene, cam, cfg, tiles)
    local, opt = shard_train_state(noisy_copy(scene, dev), gauss, lr=TRAIN_LR)
    step = make_gaussian_sharded_train_step(g16, gauss, opt,
                                            local.num_gaussians,
                                            ssim_weight=SSIM_WEIGHT)
    m, (tap, visible) = step(local, [cam], torch.nn.functional.pad(
        target, (0, 0, 0, 0, 0, g16.padded_height - g16.height))[None])
    counts = launch_counts()
    with torch.no_grad():
        ref = render(scene, cam, cfg)
    frame_equal = bool(torch.equal(img, ref.image)
                       and torch.equal(trans, ref.transmittance))
    single = noisy_copy(scene, dev)
    step_r = make_eager_train_step(g16, make_optimizer(single, TRAIN_LR),
                                   ssim_weight=SSIM_WEIGHT)
    loss_r, _, (_, vis_r) = step_r(single, [cam], target[None])
    grads = {f: close_share(getattr(local, f).grad, getattr(single, f).grad,
                            5e-3, 5e-5) for f in SCENE_FIELDS}
    grads_equal = all(g["equal"] == 1.0 for g in grads.values())
    out = dict(backend=backend, frame_equal=frame_equal,
               overflow=bool(ovf) or bool(m["overflow"]),
               loss=float(m["loss"]), single_loss=float(loss_r),
               grads=grads, grads_equal=grads_equal,
               visible_equal=bool(torch.equal(visible, vis_r)), nccl=counts)
    log(f"[nccl_world1] backend {backend}: frame bit-identical to the "
        f"single-device render {frame_equal}; Gaussian-sharded step loss "
        f"{out['loss']} single-device {out['single_loss']}, gradients "
        f"bit-identical {grads_equal}, against the single-device step "
        f"{grads}; visible equal {out['visible_equal']}")
    if not (backend == "nccl" and frame_equal and grads_equal
            and out["loss"] == out["single_loss"] and out["visible_equal"]
            and not out["overflow"]):
        raise SystemExit("nccl_world1: differs from the single-device port")
    return out


def run_sharded_bench(card: str, cap: int, per_dest: int) -> list:
    """Phase 16, the `sharded_bench` path: the tile-sharded bench through
    the CLI and the Gaussian-sharded one through the package bench, each
    under torchrun with 2 ranks on cuda:0 over gloo, at the capacities the
    tile-sharded and Gaussian-sharded phases measured; each must print its
    JSON line once (rank 0), free of overflow. Their launches happen in torchrun's
    processes, where this script cannot count them."""
    cmds = [
        ["-m", "gsplat_tpu_torch.cli", "bench", "--sharded-tiles", "2",
         "--device", "cuda:0", "--dist-backend", "gloo",
         *cli_cfg_flags(dict(BENCH, **DEFAULT, max_intersections=cap,
                             max_tiles_per_gaussian=64)),
         "--iters", "2"],
        ["-m", "gsplat_tpu_torch.bench", "--gaussian-sharded", "2",
         "--per-dest-capacity", str(per_dest), "--device", "cuda:0",
         "--dist-backend", "gloo"],
    ]
    lines = []
    for cmd in cmds:
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2", *cmd]
        t0 = time.perf_counter()
        try:
            done = subprocess.run(argv, cwd=HERE, capture_output=True,
                                  text=True, timeout=LAUNCH_TIMEOUT_S,
                                  env=dict(os.environ, PYTHONPATH=HERE))
        except subprocess.TimeoutExpired:
            raise SystemExit(f"sharded_bench: {' '.join(cmd)} passed "
                             f"{LAUNCH_TIMEOUT_S} s")
        found = [json.loads(x) for x in done.stdout.splitlines()
                 if x.startswith("{")]
        log(f"[sharded_bench] torchrun {' '.join(cmd)}: exit "
            f"{done.returncode}, {time.perf_counter() - t0:.1f} s wall, "
            f"{len(found)} JSON line(s): {found}")
        if done.returncode or len(found) != 1 or found[0].get("overflow"):
            log(done.stdout[-4000:])
            log(done.stderr[-4000:])
            raise SystemExit("sharded_bench: the command failed, did not "
                             "print one JSON line, or overflowed")
        lines.append(dict(found[0], command=" ".join(cmd), card=card))
    return lines


def check_multi_device(card: str, by_path: dict) -> dict:
    """Phases 13-17: ranks spawned on cuda:0 (gloo), the sharded benches
    under torchrun, and NCCL at world size 1. Adds each path's launches,
    summed over its ranks, to by_path; returns the numbers it printed."""
    import torch

    t0 = time.perf_counter()
    cap = shard_capacity(torch.device("cuda", 0))
    torch.cuda.empty_cache()
    multi = {"shard_capacity": cap}
    res = launch_ranks(rank_tile_sharded, 2, cap)
    by_path["tile_sharded"] = check_counts(
        "tile_sharded", sum_counts(res, "serve"),
        ("cull", "raster_fwd", "raster_fwd_packed"))
    by_path["tile_sharded_fit"] = check_counts(
        "tile_sharded_fit", sum_counts(res, "fit"),
        ("cull", "raster_fwd_packed", "raster_bwd_packed", "segsum_packed"))
    fit0, fit1 = res
    losses = [r["loss"] for r in fit0["fit_metrics"]]
    resumed = [r["loss"] for r in fit0["resume_metrics"]]
    log(f"[tile_sharded] ms per frame per rank {[r['ms'] for r in res]}; "
        f"K1 at tile_offset {fit1['tile_offset']} max abs err f32 "
        f"{fit1['k1_f32_err']} packed4 {fit1['k1_packed4_err']}")
    log(f"[tile_sharded_fit] {fit0['fit_s']:.1f} s for {FIT_STEPS} + "
        f"{FIT_STEPS - FIT_CKPT_EVERY} steps; losses {losses}, resumed "
        f"{resumed}; checkpoints {fit0['ckpts']}; rank 0 printed "
        f"{fit0['printed']!r}; rank 1 printed {fit1['printed']!r}")
    rows = {r["step"]: r["loss"] for r in fit0["fit_metrics"]}
    if not (losses[-1] < losses[0]
            and all(rows[r["step"]] == r["loss"]
                    for r in fit0["resume_metrics"])
            and fit0["ckpts"] == [f"ckpt_{FIT_CKPT_EVERY:06d}.npz"]
            and f"'densify_at': {FIT_DENSIFY_AT}" in fit0["printed"]
            and fit1["printed"] == "" and fit0["digests"] == fit1["digests"]):
        raise SystemExit("tile_sharded_fit: the loss did not fall, the "
                         "resume's rows differ from the run's, or the "
                         "checkpoint, the log or the replicas are wrong")
    multi["tile_sharded"] = [{k: r[k] for k in ("ms", "vs_single", "fit_s")
                              if k in r} for r in res]
    res = launch_ranks(rank_tile_sharded_train, 4, cap)
    by_path["tile_sharded_train"] = check_counts(
        "tile_sharded_train", sum_counts(res, "train"),
        ("cull", "raster_fwd", "raster_fwd_packed", "raster_bwd",
         "raster_bwd_packed", "segsum", "segsum_packed"))
    for name in SHARDED_STEPS:
        ls = res[0]["losses"][name]
        same = {r["digests"][name] for r in res}
        log(f"[tile_sharded_train {name}] losses {ls}; ms per step per rank "
            f"{[statistics.median(r['ms'][name]) for r in res]}; the scene "
            f"bit-identical on all four ranks: {len(same) == 1}")
        if not (statistics.mean(ls[-2:]) < statistics.mean(ls[:2])
                and len(same) == 1):
            raise SystemExit(f"tile_sharded_train {name}: the loss did not "
                             "fall, or the replicas differ")
    log(f"[tile_sharded_train] K2 at rank 3's tile offset max abs err "
        f"default {res[3]['k2_default_err']} exact {res[3]['k2_exact_err']}")
    multi["tile_sharded_train"] = dict(first=res[0]["first"], ms={
        name: [statistics.median(r["ms"][name]) for r in res]
        for name in SHARDED_STEPS})
    res = launch_ranks(rank_gaussian_sharded, 2)
    by_path["gaussian_sharded"] = check_counts(
        "gaussian_sharded", sum_counts(res, "gauss"),
        ("cull", "raster_fwd_packed", "raster_bwd_packed", "segsum_packed"))
    wire = res[0]["wire"]
    log(f"[gaussian_sharded] fragment exchange bytes per step over both "
        f"ranks: forward {wire['fwd']}, backward {wire['bwd']} (per-dest "
        f"capacity {res[0]['per_dest_capacity']}); occupancy "
        f"{res[0]['occupancy']}; frame ms per rank "
        f"{[statistics.median(r['frame_ms']) for r in res]}; step ms "
        f"{[r['step_ms'] for r in res]}; fit {[r['fit_s'] for r in res]} s, "
        f"losses {[m['loss'] for m in res[0]['metrics']]}; rank 1's K1, K2 "
        f"at tile_offset {res[1]['tile_offset']} max abs err "
        f"{res[1]['k1_err']}, {res[1]['k2_err']}; view 0's tied pairs "
        f"{res[0]['tied_pairs']}, the tie witness's "
        f"{res[0]['witness']['tied_pairs']}")
    multi["gaussian_sharded"] = [{k: r[k] for k in (
        "wire", "occupancy", "frame_ms", "step_ms", "fit_s", "step_vs_single",
        "vs_single", "tied_pairs", "witness") if k in r} for r in res]
    multi["per_dest_capacity"] = res[0]["per_dest_capacity"]
    multi["sharded_bench"] = run_sharded_bench(
        card, cap, res[0]["per_dest_capacity"])
    res = launch_ranks(rank_nccl_world1, 1, backend="nccl")
    by_path["nccl_world1"] = check_counts(
        "nccl_world1", res[0]["nccl"],
        ("cull", "raster_fwd_packed", "raster_bwd_packed", "segsum_packed"))
    multi["nccl_world1"] = {k: res[0][k] for k in (
        "frame_equal", "grads_equal", "loss", "single_loss")}
    shutil.rmtree(os.path.join(HERE, "build", "chip_smoke"),
                  ignore_errors=True)
    log(f"[multi-device] {time.perf_counter() - t0:.1f} s wall; D ranks "
        f"time-sharing one card over gloo, on {card}")
    log(json.dumps({"multi_device": multi}))
    return multi


# ---- the root tools' ports (phase 18) ---------------------------------------
# The train_protocol path: the 512x512 protocol at its full shape (a 200k
# target, a 120k init in 256k slots, 24 + 4 orbit views, batch 2), cut in
# depth to 1200 steps: the 5000-step run's position-lr horizon, the opacity
# reset at 720 (3/5 of the steps, as the full run's 3000 of 5000) and an
# eval every 300.
PROTOCOL_ARGV = ["--steps", "1200", "--lr-max-steps", "5000",
                 "--opacity-reset-every", "720", "--eval-every", "300"]
# The fit_demo path: 800 steps of each stream; the JAX demo's view-0 PSNR
# after 800 steps on a TPU (bench.py:105-112), shown beside the port's; the
# gain over the initial render each run must reach.
DEMO_STEPS = 800
DEMO_FLAGS = {"f32": ["--stream-format", "f32"],
              "packed16": ["--stream-format", "packed16", "--fast"],
              "packed4": ["--stream-format", "packed4", "--fast"]}
DEMO_JAX_TPU_DB = {"packed4": 31.46, "packed16": 31.34}
DEMO_GAIN_DB = 5.0


def run_logged(fn, argv):
    """fn(argv) with its standard output and error shown and kept:
    (its result, the output, the error)."""
    import io

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(_Tee(sys.stdout, out)), \
            contextlib.redirect_stderr(_Tee(sys.stderr, err)):
        result = fn(argv)
    return result, out.getvalue(), err.getvalue()


def check_scene_report(view0: dict, card: str) -> dict:
    """The `scene_report` path: the capacity report of the 1M random scene
    at the bench's flags (1920x1080, tile 32, K 64, its ladder, 4.1M) over
    `Camera.default` and 4 orbit views, then of the realistic scene with the
    jumbo ladder. Fails unless each reports 5 cameras, the random scene's
    camera 0 has view 0's intersections of the serve path and every
    realistic camera has its jumbo block."""
    from gsplat_tpu_torch import RenderConfig, scene_report

    cfg = RenderConfig(**BENCH)
    flags = ["--n", str(NUM_GAUSSIANS), "--width", str(cfg.width),
             "--height", str(cfg.height), "--tile-size", str(cfg.tile_size),
             "--kmax", str(cfg.max_tiles_per_gaussian),
             "--tier-spec", ",".join(f"{k}:{r}" for k, r in cfg.tier_spec),
             "--max-intersections", str(cfg.max_intersections),
             "--orbit", "4", "--device", "cuda"]
    jumbo = ["--max-tiles-jumbo", str(JUMBO["max_tiles_jumbo"]),
             "--jumbo-tier-spec",
             ",".join(f"{k}:{r}" for k, r in JUMBO["jumbo_tier_spec"])]
    out = {}
    for kind, extra in (("random", []), ("realistic", jumbo)):
        t0 = time.perf_counter()
        _, text, err = run_logged(scene_report.main,
                                  ["--scene", kind, *flags, *extra])
        cams = [json.loads(x) for x in err.splitlines()
                if x.startswith('{"tiers"')]
        worst = json.loads(text)
        out[kind] = dict(
            seconds=time.perf_counter() - t0,
            intersections=[c["num_intersections"] for c in cams],
            rect_overflow=[c["rect_overflow"] for c in cams],
            worst_camera=worst["camera"],
            suggested_max_intersections=worst["suggested_max_intersections"],
            jumbo=worst.get("jumbo"))
        log(f"[scene_report {kind}] {json.dumps(out[kind])} on {card}")
        if len(cams) != 5 or (kind == "realistic"
                              and not all("jumbo" in c for c in cams)):
            raise SystemExit(f"scene_report {kind}: not 5 cameras, or no "
                             "jumbo block")
    want = view0["serve f32"]
    log(f"[scene_report] random camera 0: "
        f"{out['random']['intersections'][0]} intersections, the serve "
        f"path's view 0 {want}")
    if out["random"]["intersections"][0] != want:
        raise SystemExit("scene_report: camera 0's intersections differ "
                         "from the serve path's view 0")
    return out


def check_step_syncs(init, cams, targets, cfg, fit) -> dict:
    """The synchronising calls of the train step (`make_train_step`, L1 +
    0.2 DSSIM, two views a step, SH degree 1 after one warm-up step) per
    step, and of `fit` run for 3 and for 6 steps with one log row each,
    densification accumulating and no eval. Fails unless the step makes
    none and both fits make as many (so that none is made per step)."""
    from gsplat_tpu_torch import GaussianScene
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step

    scene = GaussianScene(**{f: getattr(init, f).detach().clone()
                             for f in SCENE_FIELDS})
    step = make_train_step(cfg, make_optimizer(scene, TRAIN_LR),
                           ssim_weight=SSIM_WEIGHT)

    def one_step():
        return step(scene, cams[:2], targets[:2], 1)

    one_step()
    per_step, sites = count_syncs(one_step, 5)
    fits = {}
    for n in (3, 6):
        fits[n] = count_syncs(lambda: fit(
            init, cams, targets, cfg, steps=n, batch=2, log_every=n,
            ssim_weight=SSIM_WEIGHT, densify_every=100, densify_from=500,
            sh_warmup_every=1000, position_lr_final_ratio=0.01,
            lr_max_steps=5000, overflow_policy="raise"), 1)
    out = dict(step_per_iter=per_step, step_sites=sites,
               fit={n: dict(total=t, sites=st) for n, (t, st) in fits.items()})
    log(f"[train_protocol syncs] {json.dumps(out)}")
    if per_step != 0 or fits[3][0] != fits[6][0]:
        raise SystemExit("train_protocol: the train step or fit's per-step "
                         "path made a synchronising call")
    return out


def run_protocol(out_dir: str, card: str, inputs: dict,
                 fit_args: list) -> dict:
    """The `train_protocol` path: `train_protocol.main` with PROTOCOL_ARGV,
    keeping in `inputs` the first training step's own inputs to K3's
    compact stage, K1, K2 and K5, and in `fit_args` the fit's arguments.
    Fails unless the fit raised no overflow or non-finite gradient, a
    densify round split or cloned, the staged capacity tightened, the last
    log row's loss is below the first's and the last held-out PSNR is
    finite and above the first eval's."""
    import ast
    import csv

    from gsplat_tpu_torch import train_protocol
    from gsplat_tpu_torch.ops.cuda import cull, raster, segsum
    from gsplat_tpu_torch.train import loop

    real_fit = loop.fit

    def fit(*args, **kw):
        # The kernels' inputs from the fit's first step on (the targets and
        # the capacity probe run before it).
        fit_args.append(args)
        with contextlib.ExitStack() as stack:
            for module, name in ((cull, "cull_compact_cuda"),
                                 (raster, "raster_tiles_cuda"),
                                 (raster, "raster_bwd_cuda"),
                                 (segsum, "segmented_suffix_sum_packed_cuda")):
                stack.enter_context(first_inputs(inputs, module, name))
            return real_fit(*args, **kw)

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = [*PROTOCOL_ARGV, "--out-dir", out_dir, "--device", "cuda"]
    loop.fit = fit
    t0 = time.perf_counter()
    try:
        summary, text, _ = run_logged(train_protocol.main, argv)
    except (RuntimeError, FloatingPointError) as e:
        raise SystemExit(f"train_protocol: the fit raised: {e}")
    finally:
        loop.fit = real_fit
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    losses = [float(r["loss"]) for r in rows]
    evals = [float(r["holdout_psnr"]) for r in rows if r.get("holdout_psnr")]
    densify = [ast.literal_eval(x) for x in text.splitlines()
               if "'densify_at':" in x]
    tighten = [x for x in text.splitlines()
               if x.startswith("staged capacity: tightening")]
    plain_rows = [float(r["it_per_s"]) for r in rows
                  if not r.get("holdout_psnr")] or [float("nan")]
    checks = {
        "loss falls": losses[-1] < losses[0],
        "held-out PSNR finite and rises": len(evals) > 1
        and bool(np.isfinite(evals[-1])) and evals[-1] > evals[0],
        "a round split or cloned": any(
            d["num_split"] + d["num_clone"] > 0 for d in densify),
        "capacity tightened": bool(tighten),
    }
    log(f"[train_protocol] {wall:.1f} s; summary {json.dumps(summary)}; "
        f"held-out PSNR per eval {evals}; densify rounds {densify}; "
        f"{tighten}; it/s on rows without an eval: median "
        f"{statistics.median(plain_rows)}; checks {checks} on {card}")
    if not all(checks.values()):
        raise SystemExit(f"train_protocol: checks failed: {checks}")
    return dict(summary=summary, wall_s=wall, held_out=evals,
                densify=densify, tighten=tighten,
                it_per_s_median=statistics.median(plain_rows))


def check_protocol_inputs(inputs: dict, fit_args: list) -> dict:
    """After the `train_protocol` path: its first training step's own
    inputs to K3's compact stage (K 128), K1 and K2 (packed16, tile 16,
    bf16 pairs out) and K5 through the kernels and their plain versions
    (K3 0 differing entries, K1 and K2 the tolerances of phases 4 and 5,
    K5 those of 6, each relaunch bit-identical); then the step's and the
    fit's synchronising calls (`check_step_syncs`)."""
    import torch

    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.train import loop

    missing = [k for k in ("raster_tiles_cuda", "raster_bwd_cuda")
               if k not in inputs]
    if missing:
        raise SystemExit(f"train_protocol: no inputs kept for {missing}")
    k1 = inputs.pop("raster_tiles_cuda")
    col_k, tr_k, *_, err1, _ = check_k1("train_protocol packed16", *k1)
    again = raster.raster_tiles_cuda(*k1)
    same1 = torch.equal(col_k, again[0]) and torch.equal(tr_k, again[1])
    log(f"[K1 train_protocol packed16] a second launch bit-identical: "
        f"{same1}")
    if not same1:
        raise SystemExit("train_protocol: K1 relaunch differs")
    err2 = check_k2_inputs("train_protocol packed16",
                           inputs.pop("raster_bwd_cuda"))
    check_path_inputs("train_protocol", inputs, (
        "cull_compact_cuda", "segmented_suffix_sum_packed_cuda"))
    del k1, col_k, tr_k, again
    init, cams, targets, cfg = fit_args[0][:4]
    syncs = check_step_syncs(init, cams, targets, cfg, loop.fit)
    return dict(k1_err=err1, k2_err=err2, syncs=syncs)


def rank_sharded_smoke(rank: int, argv: list) -> dict:
    """One rank of the `train_sharded_smoke` path: the module's rank body,
    with this rank's launches counted."""
    from gsplat_tpu_torch import train_sharded_smoke

    rank_setup()
    reset_launch_counts()
    summary = train_sharded_smoke.rank_main(
        rank, train_sharded_smoke.parse_args(argv))
    return {"summary": summary, "smoke": launch_counts()}


def check_sharded_smoke(out_dir: str, card: str, by_path: dict) -> dict:
    """The `train_sharded_smoke` path: the smoke at its shape (128x128, 350
    steps) on a data 2 x tiles 2 mesh, four ranks sharing cuda:0 over
    gloo; the script's asserts (`check`) on rank 0's summary."""
    from gsplat_tpu_torch import train_sharded_smoke

    argv = ["--dist-backend", "gloo", "--device", "cuda:0", "--data", "2",
            "--tiles", "2", "--out-dir", out_dir]
    t0 = time.perf_counter()
    res = launch_ranks(rank_sharded_smoke, 4, argv)
    by_path["train_sharded_smoke"] = check_counts(
        "train_sharded_smoke", sum_counts(res, "smoke"),
        ("cull", "raster_fwd", "raster_bwd", "segsum"))
    summary = res[0]["summary"]
    log(f"[train_sharded_smoke] {time.perf_counter() - t0:.1f} s wall; "
        f"summary {json.dumps(summary)}; 4 ranks time-sharing one card "
        f"over gloo, on {card}")
    try:
        train_sharded_smoke.check(
            summary, train_sharded_smoke.parse_args(argv).init_n)
    except AssertionError as e:
        raise SystemExit(f"train_sharded_smoke: {e}")
    return summary


def check_fit_demo(out_dir: str, card: str) -> dict:
    """The `fit_demo` path: DEMO_STEPS steps of each stream (float32;
    packed16 and packed4 with --fast). Fails unless each fitted view-0 PSNR
    is finite and DEMO_GAIN_DB above its initial render's."""
    from gsplat_tpu_torch import fit_demo

    out = {}
    for fmt, flags in DEMO_FLAGS.items():
        t0 = time.perf_counter()
        r = fit_demo.main(["--steps", str(DEMO_STEPS), *flags, "--out-dir",
                           os.path.join(out_dir, fmt), "--device", "cuda"])
        its = [m["it_per_s"] for m in r["metrics"][1:]]
        out[fmt] = dict(psnr=r["psnr"], initial_psnr=r["initial_psnr"],
                        wall_s=time.perf_counter() - t0,
                        it_per_s_median=statistics.median(its),
                        jax_tpu_psnr=DEMO_JAX_TPU_DB.get(fmt))
        jax_db = DEMO_JAX_TPU_DB.get(fmt)
        log(f"[fit_demo {fmt}] view-0 PSNR {r['psnr']} dB after "
            f"{DEMO_STEPS} steps (initial {r['initial_psnr']} dB"
            + (f"; the JAX demo on a TPU: {jax_db} dB" if jax_db else "")
            + f"); {json.dumps(out[fmt])} on {card}")
        if not (np.isfinite(r["psnr"])
                and r["psnr"] >= r["initial_psnr"] + DEMO_GAIN_DB):
            raise SystemExit(f"fit_demo {fmt}: PSNR not finite or not "
                             f"{DEMO_GAIN_DB} dB above the initial render's")
    shutil.rmtree(out_dir, ignore_errors=True)
    return out


def check_tools(card: str, by_path: dict, view0: dict) -> dict:
    """Phase 18: the ports of the root tools, each a main path."""
    import torch

    root = os.path.join(HERE, "build", "chip_smoke", "tools")
    tools, seconds = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        seconds[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()

    timed("scene_report", lambda: by_path.update(scene_report=drive(
        "scene_report", ("cull",), lambda: tools.update(
            scene_report=check_scene_report(view0, card)))))
    inputs, fit_args = {}, []
    timed("train_protocol", lambda: by_path.update(train_protocol=drive(
        "train_protocol", ("cull", "raster_fwd_packed", "raster_bwd_packed",
                           "segsum_packed"), lambda: tools.update(
            train_protocol=run_protocol(os.path.join(root, "protocol"),
                                        card, inputs, fit_args)))))
    # The kernels on the path's own inputs, and the syncs, after the path:
    # their launches are not the path's.
    timed("train_protocol checks", lambda: tools["train_protocol"].update(
        check_protocol_inputs(inputs, fit_args)))
    timed("train_sharded_smoke", lambda: tools.update(
        train_sharded_smoke=check_sharded_smoke(
            os.path.join(root, "sharded_smoke"), card, by_path)))
    timed("fit_demo", lambda: by_path.update(fit_demo=drive(
        "fit_demo", ("cull", "raster_fwd", "raster_fwd_packed", "raster_bwd",
                     "raster_bwd_packed", "segsum", "segsum_packed"),
        lambda: tools.update(fit_demo=check_fit_demo(
            os.path.join(root, "demo"), card)))))
    shutil.rmtree(root, ignore_errors=True)
    log(f"[tools] seconds per path {seconds}")
    log(json.dumps({"tools": tools}, default=str))
    return tools


# Phase 19: the captured paths. A substring of each path kernel's demangled
# name in the profiler's records, and the launch counts (names of
# ops/cuda/counters.py) whose launches it makes.
PROFILE_NAMES = {
    "cull": ("cull_kernel", K3_STAGES),
    "raster_fwd": ("raster_fwd_kernel", ("K1", "K1.packed")),
    "raster_bwd": ("raster_bwd_kernel", ("K2", "K2.packed")),
    "segsum": ("F32Rows", ("K4",)),
    "segsum_packed": ("Bf16Pairs", ("K5",)),
}
JIT_STEPS = 10       # steps from one init, eager and captured
JIT_TIMED = 8        # frames or calls timed, eager and replayed


def profile_window(fn, calls: int, skip=()) -> dict:
    """fn called `calls` times under torch.profiler (CPU and CUDA), after a
    synchronise and ending in one: per call, the host wall ms, the device
    ms of every kernel, memset and copy (the device's busy time; the
    device side of the spans in `skip` left out), the busy share of the
    wall, and each kernel's ms and count by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    kernels: dict = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and e.name not in skip):
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.device_time_total
            k[1] += 1
    busy = sum(v[0] for v in kernels.values()) / 1e3 / calls
    return dict(wall_ms=wall, kernel_ms=busy, busy_share=busy / wall,
                kernels={name: dict(ms=v[0] / 1e3 / calls, calls=v[1] / calls)
                         for name, v in sorted(kernels.items(),
                                               key=lambda kv: -kv[1][0])})


def path_kernels(prof: dict, launches: dict, per: int = 1) -> dict:
    """Per path kernel of PROFILE_NAMES: its calls per replay in the
    profiler's records (of `per` replays), and the launches one replay
    makes by the graph's own count (`Entry.launches`, the launch counts'
    rise at capture)."""
    out = {}
    for name, (sub, names) in PROFILE_NAMES.items():
        out[name] = dict(
            profiler=sum(v["calls"] for k, v in prof["kernels"].items()
                         if sub in k) / per,
            counted=sum(launches.get(c, 0) for c in names))
    return out


def kernels_off(kern: dict, needs) -> bool:
    """True if a kernel in `needs` is missing from the profiler's records
    of a replay, or any path kernel's records differ from the graph's own
    count."""
    return (any(kern[n]["profiler"] == 0 for n in needs)
            or any(k["profiler"] != k["counted"] for k in kern.values()))


def timed_calls(fn, n: int) -> dict:
    """fn(i) for i < n, each between CUDA events and a host clock that
    ends in a synchronise: the medians, ms."""
    import torch

    host, device = [], []
    for i in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        fn(i)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        device.append(start.elapsed_time(end))
    return dict(host_ms=statistics.median(host),
                device_ms=statistics.median(device), n=n)


def check_render_jit(scene, rscene, cams, card, by_path) -> dict:
    """The `render_jit` path at the bench config: the random and the
    realistic 1M scene (the realistic one with the jumbo ladder), float32
    and packed4. The path (counted in by_path["render_jit"]): for each,
    `render_jit` of the four views in turn, twice (the first call warms up
    and captures, the other seven replay), the peak memory of these calls
    above what was allocated before. Then, outside the path's count: every
    output bit-identical to eager `render` of its view, one capture, 0
    synchronising calls per replay, and one profiled pass of four replays
    naming K3 and K1 (their calls per replay equal to the graph's counted
    launches); eager and replayed frames timed (CUDA events and the host
    clock) and the busy share of the profiled replays."""
    import torch

    from gsplat_tpu_torch import RenderConfig, render, render_jit
    from gsplat_tpu_torch.render import pipeline
    from gsplat_tpu_torch.utils import graphs

    fields = ("image", "transmittance", "num_intersections", "overflow",
              "gauss_counts")
    cases = [(tag, sc, RenderConfig(**dict(BENCH, **extra)))
             for tag, sc, extra in (
                 ("random f32", scene, {}),
                 ("random packed4", scene, DEFAULT),
                 ("realistic f32", rscene, dict(EXACT, **JUMBO)),
                 ("realistic packed4", rscene, dict(DEFAULT, **JUMBO)))]
    runs = {}

    def path():
        for tag, sc, cfg in cases:
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            caps = graphs.captures["render"]
            got = [render_jit(sc, cam, cfg) for _ in range(2) for cam in cams]
            torch.cuda.synchronize()
            runs[tag] = dict(
                got=got, peak=torch.cuda.max_memory_allocated() - base,
                captured=graphs.captures["render"] - caps,
                entry=next(reversed(pipeline.RENDER_GRAPHS.entries.values())))

    by_path["render_jit"] = drive(
        "render_jit", ("cull", "cull_rank", "raster_fwd",
                       "raster_fwd_packed"), path)
    out = {}
    caps = graphs.captures["render"]
    for tag, sc, cfg in cases:
        run = runs.pop(tag)
        entry = run["entry"]
        with torch.no_grad():
            eager = [render(sc, c, cfg) for c in cams]
        differ = [(k // len(cams), k % len(cams), f)
                  for k, got in enumerate(run["got"]) for f in fields
                  if not torch.equal(getattr(got, f),
                                     getattr(eager[k % len(cams)], f))]
        del eager, run["got"]
        syncs, sites = count_syncs(lambda: [render_jit(sc, c, cfg)
                                            for c in cams], 1)
        with torch.no_grad():
            eager_t = timed_calls(lambda i: render(sc, cams[i % 4], cfg),
                                  JIT_TIMED)
        replay_t = timed_calls(lambda i: render_jit(sc, cams[i % 4], cfg),
                               JIT_TIMED)
        prof = profile_window(lambda: [render_jit(sc, c, cfg) for c in cams],
                              1, skip=pipeline.STAGES)
        kern = path_kernels(prof, entry.launches, len(cams))
        row = dict(differ=differ, captures=run["captured"],
                   capture_s=entry.capture_s,
                   syncs_per_replay=syncs / len(cams),
                   sync_sites=sites, eager=eager_t, replay=replay_t,
                   replay_busy_share=prof["busy_share"],
                   replay_profiled_wall_ms=prof["wall_ms"] / len(cams),
                   replay_kernel_ms=prof["kernel_ms"] / len(cams),
                   path_kernels=kern, peak_bytes=run["peak"],
                   top_kernels=dict(list(prof["kernels"].items())[:8]))
        log(f"[render_jit {tag}] {json.dumps(row, default=str)}")
        out[tag] = row
        if (differ or run["captured"] != 1 or syncs
                or graphs.captures["render"] != caps
                or kernels_off(kern, ("cull", "raster_fwd"))):
            raise SystemExit(f"render_jit {tag}: a replayed frame differs "
                             "from eager render, not one capture, a "
                             "synchronising call, or the profiler's K3 / K1 "
                             "records missing or off the graph's launches")
        torch.cuda.empty_cache()
    log(f"[render_jit] on {card}")
    return out


def check_train_jit(scene, rscene, cams, dev, card, by_path) -> dict:
    """The captured train step (`make_train_step`) at the exact and the
    bench-default configurations on both scenes. The path (counted in
    by_path["train_jit"]): JIT_STEPS steps of each configuration's captured
    step from one init (its first call warms up and captures, the rest
    replay), and the peak memory of those steps above what was allocated
    before them. Then, outside the path's count: JIT_STEPS steps of the
    eager body (`make_eager_train_step`) from a second copy of the init.
    The losses, the last step's tap gradients and visibility and the final
    parameters must be bit-identical; where they are not, each differing
    output is named, held to rtol 5e-3 / atol 1e-5, and one eager step
    under `torch.use_deterministic_algorithms(True, warn_only=True)` names
    the ops without a deterministic implementation. Then 0 synchronising
    calls per replayed step, one profiled pass of the four views naming K2
    and K4 (exact) or K5 (default), and the eager and replayed steps'
    times."""
    import torch

    from gsplat_tpu_torch import RenderConfig
    from gsplat_tpu_torch.render.pipeline import STAGES
    from gsplat_tpu_torch.train.loop import TRAIN_SPANS
    from gsplat_tpu_torch.utils import graphs

    cases = [(tag, sc, RenderConfig(**dict(BENCH, **extra)), seg)
             for tag, sc, extra, seg in (
                 ("exact random", scene, EXACT, "segsum"),
                 ("exact realistic", rscene, dict(EXACT, **JUMBO), "segsum"),
                 ("default random", scene, DEFAULT, "segsum_packed"),
                 ("default realistic", rscene, dict(DEFAULT, **JUMBO),
                  "segsum_packed"))]
    # The trainers (their targets rendered eagerly) before the path.
    trainers = {tag: make_trainer(sc, cams, cfg, dev)
                for tag, sc, cfg, _ in cases}
    captured = {}

    def path():
        for tag, _, _, _ in cases:
            caps = graphs.captures["train_step"]
            train, targets, step = trainers[tag]
            run = {}
            peak = peak_of(lambda: run.update(c5.run_steps(
                step, train, cams, targets, JIT_STEPS)))
            captured[tag] = dict(run, peak_bytes=peak,
                                 captures=graphs.captures["train_step"] - caps)

    by_path["train_jit"] = drive(
        "train_jit", ("cull", "raster_fwd", "raster_fwd_packed",
                      "raster_bwd", "raster_bwd_packed", "segsum",
                      "segsum_packed"), path)
    out = {}
    for tag, sc, cfg, seg in cases:
        c = captured.pop(tag)
        train, targets, step = trainers.pop(tag)
        caps = graphs.captures["train_step"]
        syncs, sites = count_syncs(
            lambda: step(train, [cams[0]], targets[:1]), 2)
        prof = profile_window(
            lambda: [step(train, [cam], targets[v:v + 1])
                     for v, cam in enumerate(cams)], 1,
            skip=TRAIN_SPANS + STAGES)
        (entry,) = step.graphs.entries.values()
        kern = path_kernels(prof, entry.launches, len(cams))
        recaptured = graphs.captures["train_step"] - caps
        del train, targets, step
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        train, targets, step = make_trainer(sc, cams, cfg, dev, eager=True)
        e = {}
        e["peak_bytes"] = peak_of(lambda: e.update(c5.run_steps(
            step, train, cams, targets, JIT_STEPS)))
        del train, targets, step
        differ = c5.differing(c5.run_pairs(c, e))
        nondet = []
        if differ:
            def one_step():
                train, targets, step = make_trainer(sc, cams, cfg, dev,
                                                    eager=True)
                step(train, [cams[0]], targets[:1])

            nondet = nondeterministic_ops(one_step)
        row = dict(
            bit_identical=not differ, differ=differ, nondeterministic=nondet,
            losses=c["losses"].tolist(), eager_ms=dict(
                host=e["host_ms"], device=e["device_ms"]),
            replay_ms=dict(host=c["host_ms"], device=c["device_ms"]),
            captures=c["captures"], capture_s=entry.capture_s,
            syncs_per_replay=syncs, sync_sites=sites,
            busy_share=prof["busy_share"],
            profiled_wall_ms=prof["wall_ms"] / len(cams),
            kernel_ms=prof["kernel_ms"] / len(cams),
            path_kernels=kern,
            top_kernels=dict(list(prof["kernels"].items())[:8]),
            peak_bytes=dict(eager=e["peak_bytes"],
                            captured=c["peak_bytes"]))
        log(f"[train_jit {tag}] {json.dumps(row, default=str)}")
        out[tag] = row
        needs = ("cull", "raster_fwd", "raster_bwd", seg)
        if (any(r["overflow"] or not r["finite"] for r in (c, e))
                or c["captures"] != 1 or recaptured
                or syncs
                or any(not d["within"] for d in differ.values())
                or kernels_off(kern, needs)):
            raise SystemExit(f"train_jit {tag}: a step overflowed or went "
                             "non-finite, not one capture, a synchronising "
                             "call, the captured steps outside rtol 5e-3 / "
                             "atol 1e-5 of the eager steps, or the "
                             f"profiler's records of {needs} missing or off "
                             "the graph's launches")
        del c, e
        torch.cuda.empty_cache()
    log(f"[train_jit] on {card}")
    return out


def check_loss_and_grad_jit(scene, cams, card, by_path) -> dict:
    """`render_loss_and_grad` at the bench-default config on the random
    scene, the bench's fwd_bwd call. The path (counted in
    by_path["loss_and_grad_jit"]): the four views in turn, twice (the first
    call warms up and captures, the other seven replay), and the peak
    memory of these calls above what was allocated before. Then, outside
    the path's count: each loss and gradient bit-identical to the eager
    body's on its view, 0 synchronising calls per replay, one profiled
    pass of four calls of `utils.bench.bench_iteration(..., "fwd_bwd")`
    naming K3, K1, K2 and K5 (their calls per replay equal to the graph's
    counted launches), and the eager and replayed calls' times."""
    import torch

    from gsplat_tpu_torch import RenderConfig
    from gsplat_tpu_torch.render import pipeline
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS, STAGES
    from gsplat_tpu_torch.utils import graphs
    from gsplat_tpu_torch.utils.bench import bench_iteration

    cfg = RenderConfig(**dict(BENCH, **DEFAULT))
    target = torch.zeros((cfg.height, cfg.width, 3), device=scene.means.device)
    got = []
    run = {}

    def path():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        caps = graphs.captures["loss_and_grad"]
        got.extend(pipeline.render_loss_and_grad(scene, cam, target, cfg)
                   for _ in range(2) for cam in cams)
        torch.cuda.synchronize()
        run.update(peak=torch.cuda.max_memory_allocated() - base,
                   captured=graphs.captures["loss_and_grad"] - caps)

    by_path["loss_and_grad_jit"] = drive(
        "loss_and_grad_jit", ("cull", "raster_fwd_packed",
                              "raster_bwd_packed", "segsum_packed"), path)
    caps = graphs.captures["loss_and_grad"]
    same = []
    for k, (loss, grads) in enumerate(got):
        want_loss, want = pipeline._loss_and_grad(
            scene, cams[k % len(cams)], target, cfg)
        same.append(bool(torch.equal(loss, want_loss)) and all(
            torch.equal(getattr(grads, f), getattr(want, f))
            for f in SCENE_FIELDS))
    got.clear()
    del want, want_loss
    torch.cuda.empty_cache()
    syncs, sites = count_syncs(
        lambda: [pipeline.render_loss_and_grad(scene, c, target, cfg)
                 for c in cams], 1)
    eager_t = timed_calls(lambda i: pipeline._loss_and_grad(
        scene, cams[i % 4], target, cfg), JIT_TIMED)
    replay_t = timed_calls(lambda i: pipeline.render_loss_and_grad(
        scene, cams[i % 4], target, cfg), JIT_TIMED)
    fns = [bench_iteration(scene, c, cfg, "fwd_bwd") for c in cams]
    prof = profile_window(lambda: [fn() for fn in fns], 1, skip=STAGES)
    entry = next(reversed(pipeline.LOSS_AND_GRAD_GRAPHS.entries.values()))
    kern = path_kernels(prof, entry.launches, len(cams))
    row = dict(bit_identical=same, captures=run["captured"],
               capture_s=entry.capture_s, syncs_per_replay=syncs / len(cams),
               sync_sites=sites, eager=eager_t, replay=replay_t,
               replay_busy_share=prof["busy_share"],
               replay_profiled_wall_ms=prof["wall_ms"] / len(cams),
               replay_kernel_ms=prof["kernel_ms"] / len(cams),
               path_kernels=kern, peak_bytes=run["peak"],
               top_kernels=dict(list(prof["kernels"].items())[:8]))
    log(f"[loss_and_grad_jit] {json.dumps(row, default=str)} on {card}")
    if (not all(same) or run["captured"] != 1 or syncs
            or graphs.captures["loss_and_grad"] != caps
            or kernels_off(kern, ("cull", "raster_fwd", "raster_bwd",
                                  "segsum_packed"))):
        raise SystemExit("loss_and_grad_jit: a replayed loss or gradient "
                         "differs from the eager body's, not one capture, a "
                         "synchronising call, or the profiler's K3 / K1 / "
                         "K2 / K5 records of the bench's fwd_bwd replays "
                         "missing or off the graph's launches")
    return row


def check_cli_train_eager(out_dir: str, captured: dict, card: str) -> dict:
    """`cli train` (cli_train_argv) once more with the train step and the
    densify round run eagerly (`make_train_step` patched to
    `make_eager_train_step`, `densify_and_prune_jit` to
    `densify_and_prune`): its
    log rows' losses and held-out PSNRs against phase 10's run on the
    captured step, which must end at the same held-out PSNR."""
    import csv

    from gsplat_tpu_torch.train import densify, loop

    os.makedirs(out_dir, exist_ok=True)
    captured_step = loop.make_train_step
    captured_densify = densify.densify_and_prune_jit
    loop.make_train_step = loop.make_eager_train_step
    densify.densify_and_prune_jit = densify.densify_and_prune
    t0 = time.perf_counter()
    try:
        cli_run(cli_train_argv(out_dir))
    finally:
        loop.make_train_step = captured_step
        densify.densify_and_prune_jit = captured_densify
    wall = time.perf_counter() - t0
    with open(os.path.join(out_dir, "metrics.csv")) as f:
        rows = list(csv.DictReader(f))
    keys = ("step", "loss", "holdout_psnr", "train_psnr")
    eager_rows = [{k: r.get(k) for k in keys} for r in rows]
    graph_rows = [{k: r.get(k) for k in keys} for r in captured["rows"]]
    last = (eager_rows[-1]["holdout_psnr"], graph_rows[-1]["holdout_psnr"])
    out = dict(wall_s=wall, captured_wall_s=captured["wall_s"],
               rows_equal=eager_rows == graph_rows, holdout_psnr=last,
               eager_rows=eager_rows)
    log(f"[cli_train eager] {json.dumps(out)} on {card}")
    if last[0] != last[1] or not last[0]:
        raise SystemExit(f"cli_train eager: held-out PSNR at step "
                         f"{CLI_STEPS} {last[0]} on the eager step, "
                         f"{last[1]} on the captured one")
    return out


# ---- phase 20: the multi-device programs as CUDA graphs on NCCL -------------
# JIT_RANKS NCCL ranks share cuda:0, each taken by NCCL for a host of its
# own (`multihost.share_card_env`): every collective crosses the loopback's
# TCP through NCCL's socket transport, and the ranks time-share the card.
# Their times are those of that setting, not of NVLink or of several cards.
JIT_RANKS = 2
# NCCL's kernels in the profiler's records (one per collective the port
# issues: the "collectives" launch count, which a replay adds per graph).
NCCL_KERNEL = "ncclDevKernel"
MESH_FIT_STEPS, MESH_FIT_DENSIFY_AT = 60, 30
MESH_TIMED = 4       # calls timed per program, eager and replayed
JIT_LAUNCH_TIMEOUT_S = 900


def rank_nccl_collectives(rank: int) -> dict:
    """NCCL ranks sharing cuda:0: all_reduce, all_gather and
    all_to_all_single eagerly, then captured in a graph in each
    capture_error_mode and replayed on new inputs, each against the values
    it must give. Returns {"eager": ok, mode: ok or the error}."""
    import torch

    dist = torch.distributed
    dev = torch.device("cuda", 0)
    n = dist.get_world_size()
    x = torch.full((4096,), float(rank + 1), device=dev)
    blocks = torch.arange(4 * n, dtype=torch.float32, device=dev) + 100 * rank

    def collectives():
        total = x * 1
        dist.all_reduce(total)
        every = [torch.empty_like(x[:8]) for _ in range(n)]
        dist.all_gather(every, x[:8].contiguous())
        moved = torch.empty_like(blocks)
        dist.all_to_all_single(moved, blocks * 1)
        return total, every, moved

    def ok(got, k):
        total, every, moved = got
        want = torch.cat([torch.arange(4 * rank, 4 * rank + 4, device=dev)
                          + 100 * s for s in range(n)]).float()
        return (bool((total == sum(range(1, n + 1)) + n * k).all())
                and all(bool((e == s + 1 + k).all())
                        for s, e in enumerate(every))
                and bool(torch.equal(moved, want)))

    out = {"eager": ok(collectives(), 0)}
    # The step's gradient all_reduce (244 MB) and a Gaussian-sharded
    # frame's exchange (115 MB per rank), eager, seconds each.
    for name, nbytes in (("all_reduce_s", 244_000_000),
                         ("all_to_all_s", 115_000_000)):
        buf = torch.ones(nbytes // 4, device=dev)
        got = torch.empty_like(buf)
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "all_reduce_s":
                dist.all_reduce(buf)
            else:
                dist.all_to_all_single(got, buf)
            torch.cuda.synchronize()
        out[name] = time.perf_counter() - t0
        del buf, got
    for mode in ("thread_local", "global", "relaxed"):
        x.fill_(float(rank + 1))
        dist.all_reduce(torch.zeros(1, device=dev))  # an eager one just before
        try:
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode=mode):
                got = collectives()
            x.fill_(float(rank + 2))
            graph.replay()
            torch.cuda.synchronize()
            out[mode] = ok(got, 1)
        except RuntimeError as e:
            out[mode] = str(e)[:300]
    return out


def rank_nccl_refused(rank: int) -> dict:
    """One all_reduce on cuda:0 with NCCL's own host hash: NCCL's answer to
    two ranks of one host on one card."""
    import torch

    torch.distributed.all_reduce(torch.zeros(1, device="cuda:0"))
    torch.cuda.synchronize()
    return {}


def check_nccl_share(card: str) -> dict:
    """Two NCCL ranks on cuda:0: without `multihost.share_card_env` (NCCL's
    refusal, quoted), and with it (`rank_nccl_collectives`)."""
    try:
        launch_ranks(rank_nccl_refused, 2, backend="nccl", timeout_s=120)
        refused = "no refusal"
    except SystemExit as e:
        text = str(e)
        i = text.find("Duplicate GPU")
        refused = text[i:text.find("\n", i)] if i >= 0 else text[-300:]
    res = launch_ranks(rank_nccl_collectives, JIT_RANKS, backend="nccl",
                       share_card=True, timeout_s=180)
    out = dict(refused=refused, shared=res)
    log(f"[nccl_share] {json.dumps(out)} on {card}")
    if not all(v is True for r in res for k, v in r.items()
               if not k.endswith("_s")):
        raise SystemExit("nccl_share: a collective on NCCL ranks sharing "
                         "the card gave a wrong value or failed to capture")
    return out


def rank_counted(fn) -> dict:
    """fn() with this rank's launch counts set to 0 just before and read
    just after, the collectives it issued beside them."""
    from gsplat_tpu_torch.ops.cuda import counters

    reset_launch_counts()
    fn()
    return dict(launch_counts(),
                collectives=counters.snapshot()["collectives"])


def replay_report(replay, eager, entry, needs, skip=()):
    """A captured program's replays against its eager body, outside the
    path's count: replay(i) and eager(i) are the i-th call of each (view i
    mod 4). Synchronising calls per replay over four replays; eager and
    replayed calls timed (CUDA events and the host clock, medians of
    MESH_TIMED); one profiled pass of four replays: the busy share, the path
    kernels' and NCCL's kernels per replay against the graph's counts.
    Returns (row, off), off when a kernel in `needs` is missing or any
    count differs."""
    syncs, sites = count_syncs(lambda: [replay(i) for i in range(4)], 1)
    eager_t = timed_calls(eager, MESH_TIMED)
    replay_t = timed_calls(replay, MESH_TIMED)
    prof = profile_window(lambda: [replay(i) for i in range(4)], 1, skip=skip)
    kern = path_kernels(prof, entry.launches, 4)
    nccl = dict(profiler=sum(v["calls"] for k, v in prof["kernels"].items()
                             if NCCL_KERNEL in k) / 4,
                counted=entry.launches.get("collectives", 0))
    row = dict(syncs_per_replay=syncs / 4, sync_sites=sites, eager=eager_t,
               replay=replay_t, busy_share=prof["busy_share"],
               profiled_wall_ms=prof["wall_ms"] / 4,
               kernel_ms=prof["kernel_ms"] / 4, path_kernels=kern, nccl=nccl,
               capture_s=entry.capture_s,
               top_kernels=dict(list(prof["kernels"].items())[:8]))
    off = bool(syncs) or kernels_off(kern, needs) or (
        nccl["profiler"] != nccl["counted"])
    return row, off


def nondeterministic_ops(fn) -> list:
    """The warnings of torch's deterministic mode over fn() (one eager
    step; every rank calls it where any rank asks, so that the ranks issue
    the same collectives)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            fn()
            torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
    return sorted({str(w.message)[:160] for w in caught
                   if "deterministic" in str(w.message)})


def peak_of(fn) -> int:
    """fn(), and the peak memory of it above what was allocated before."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() - base


def rank_multi_device_jit(rank: int, cap: int, per_dest: int) -> dict:
    """Phase 20 on one of JIT_RANKS NCCL ranks sharing cuda:0: every
    multi-device program of the port as a captured CUDA graph per rank,
    each path counted on its captured calls alone (the first call, which
    warms up and captures, and the replays), the eager references, the
    syncs, the times and the profiled replays after:
      - tile_sharded_jit: `render_tile_sharded_jit` (data 1 x tiles D) of
        the 1M scene at the bench config, float32 and packed4, the four
        views twice, each frame bit-identical to eager `render_tile_sharded`
        on the same ranks and to the single-device `render`;
      - gaussian_sharded_jit: `render_gaussian_sharded_jit` (gauss D,
        packed16 wire, the scene padded to GAUSS_CAPACITY, per-dest
        capacity `per_dest`), bit-identical to the eager body;
      - sharded_train_jit: the tile-sharded step, bench default and
        --exact-grads, JIT_STEPS captured steps from a noisy copy against
        JIT_STEPS eager steps (`make_eager_sharded_train_step`) from a
        second copy: losses, tap gradients, visibility and parameters
        bit-identical, or named and within rtol 5e-3 / atol 1e-5;
      - gaussian_train_jit: the Gaussian-sharded step the same way;
      - fit_mesh_jit: `fit(mesh=...)` MESH_FIT_STEPS steps with a densify
        round at MESH_FIT_DENSIFY_AT, against the same fit on the eager
        step and the eager densify round: log rows and scenes equal;
      - densify_jit: the Gaussian-sharded densify program and the
        single-device `densify_and_prune_jit`, each twice on the trained
        shard or scene and the steps' accumulator, against their eager
        bodies bit for bit.
    Each program: one capture per key on this rank, 0 synchronising calls
    per replay, the profiler's records of a replay naming its kernels and
    NCCL's as often as the graph counts them, eager and replayed ms, the
    busy share and the peak memory of its captured calls."""
    import contextlib as ctx
    import io

    import torch

    from gsplat_tpu_torch import RenderConfig, render
    from gsplat_tpu_torch.parallel import gaussian_sharded as gs
    from gsplat_tpu_torch.parallel import gaussian_train as gt
    from gsplat_tpu_torch.parallel import sharding as sh
    from gsplat_tpu_torch.parallel import train_step as ts
    from gsplat_tpu_torch.render.pipeline import STAGES
    from gsplat_tpu_torch.train import densify
    from gsplat_tpu_torch.train.loop import TRAIN_SPANS, fit, make_optimizer
    from gsplat_tpu_torch.utils import graphs

    dev = rank_setup()
    d = torch.distributed.get_world_size()
    grid = sh.make_mesh({"data": 1, "tiles": d}, dev)
    gauss = sh.make_mesh({"gauss": d}, dev)
    scene = bench_scene(dev)
    cams = views(BENCH["width"], BENCH["height"], dev)
    out = {"rank": rank, "backend": torch.distributed.get_backend(),
           "counts": {}, "rows": {}, "bad": []}
    skip = TRAIN_SPANS + STAGES + ("train.allreduce",)
    t_start = time.perf_counter()

    def progress(what):
        log(f"[multi_device_jit rank {rank}] {what} at "
            f"{time.perf_counter() - t_start:.1f} s")

    def entry_of(cache):
        return next(reversed(cache.entries.values()))

    # The renders.
    packed16 = RenderConfig(**dict(BENCH, **dict(
        DEFAULT, stream_format="packed16", fragment_format="bf16")))
    local = gs.shard_scene(scene.pad_to(GAUSS_CAPACITY), gauss)
    renders = {
        f"render tile {fmt}": (
            "tile_sharded_jit", "render_tile_sharded", sh.TILE_SHARDED_GRAPHS,
            lambda c, cfg=cfg: sh.render_tile_sharded_jit(scene, c, cfg, grid),
            lambda c, cfg=cfg: sh.render_tile_sharded(scene, c, cfg, grid),
            cfg, ("cull", "raster_fwd"))
        for fmt, cfg in (
            ("f32", RenderConfig(**dict(BENCH, max_intersections=cap))),
            ("packed4", RenderConfig(**dict(BENCH, **DEFAULT,
                                            max_intersections=cap))))}
    renders["render gauss packed16"] = (
        "gaussian_sharded_jit", "render_gaussian_sharded",
        gs.GAUSSIAN_SHARDED_GRAPHS,
        lambda c: gs.render_gaussian_sharded_jit(local, c, packed16, gauss,
                                                 per_dest_capacity=per_dest),
        lambda c: gs.render_gaussian_sharded(local, c, packed16, gauss,
                                             per_dest_capacity=per_dest),
        packed16, ("cull", "raster_fwd"))
    got = {}
    for path in ("tile_sharded_jit", "gaussian_sharded_jit"):
        def run_path(path=path):
            for tag, (p, kind, _, jit, _, _, _) in renders.items():
                if p != path:
                    continue
                caps = graphs.captures[kind]
                frames = []
                peak = peak_of(lambda: frames.extend(
                    jit(c) for _ in range(2) for c in cams))
                got[tag] = (frames, peak, graphs.captures[kind] - caps)

        out["counts"][path] = rank_counted(run_path)
        progress(f"path {path}")
    for tag, (_, kind, cache, jit, eager, cfg, needs) in renders.items():
        frames, peak, captured = got.pop(tag)
        entry = entry_of(cache)
        caps = graphs.captures[kind]
        differ, single = [], []
        for k, frame in enumerate(frames):
            with torch.no_grad():
                want = eager(cams[k % 4])
            differ += [(k, i) for i in range(3)
                       if not torch.equal(frame[i], want[i])]
            if tag.startswith("render tile") and k < 4:
                with torch.no_grad():
                    ref = render(scene, cams[k], dataclasses.replace(
                        cfg, max_intersections=_bench.CARD[
                            "max_intersections"]))
                if not (torch.equal(frame[0], ref.image)
                        and torch.equal(frame[1], ref.transmittance)):
                    single.append(k)
            if bool(frame[2]):
                differ.append((k, "overflow"))
        del frames, want
        torch.cuda.empty_cache()

        def replay(i, jit=jit):
            return jit(cams[i % 4])

        def eager_call(i, eager=eager):
            with torch.no_grad():
                return eager(cams[i % 4])

        row, off = replay_report(replay, eager_call, entry, needs, skip)
        row.update(differ=differ, single_differ=single, captures=captured,
                   recaptured=graphs.captures[kind] - caps, peak_bytes=peak)
        out["rows"][tag] = row
        if differ or single or captured != 1 or row["recaptured"] or off:
            out["bad"].append(tag)
        progress(f"{tag} checked")
    del local

    # The steps.
    trained = {}
    steps = {}
    for name, extra, seg in (("default", DEFAULT, "segsum_packed"),
                             ("exact", EXACT, "segsum")):
        full = RenderConfig(**dict(BENCH, **extra))
        cfg = dataclasses.replace(full, max_intersections=cap)
        with torch.no_grad():
            targets = torch.stack([render(scene, c, full).image for c in cams])
        padded = torch.nn.functional.pad(
            targets, (0, 0, 0, cfg.padded_width - cfg.width, 0,
                      cfg.padded_height - cfg.height))
        _, bands = ts.shard_batch(cams, padded, grid)
        steps[f"step tile {name}"] = (
            "sharded_train_step",
            lambda opt, cfg=cfg: ts.make_sharded_train_step(
                cfg, grid, opt, SSIM_WEIGHT),
            lambda opt, cfg=cfg: ts.make_eager_sharded_train_step(
                cfg, grid, opt, SSIM_WEIGHT),
            lambda: noisy_copy(scene, dev).pad_to(GAUSS_CAPACITY), bands,
            grid, ("cull", "raster_fwd", "raster_bwd", seg))
    with torch.no_grad():
        targets = torch.stack([render(scene, c, packed16).image for c in cams])
    lcfg = sh.local_tile_cfg(packed16, d)
    bands = torch.nn.functional.pad(
        targets, (0, 0, 0, packed16.padded_width - packed16.width, 0,
                  packed16.padded_height - packed16.height))[
        :, rank * lcfg.height:(rank + 1) * lcfg.height]

    def gauss_init():
        return gs.shard_scene(noisy_copy(scene, dev).pad_to(GAUSS_CAPACITY),
                              gauss)

    steps["step gauss packed16"] = (
        "gaussian_sharded_train_step",
        lambda opt: gt.make_gaussian_sharded_train_step(
            packed16, gauss, opt, GAUSS_CAPACITY, ssim_weight=SSIM_WEIGHT,
            per_dest_capacity=per_dest),
        lambda opt: gt.make_eager_gaussian_sharded_train_step(
            packed16, gauss, opt, GAUSS_CAPACITY, ssim_weight=SSIM_WEIGHT,
            per_dest_capacity=per_dest),
        gauss_init, bands, gauss,
        ("cull", "raster_fwd", "raster_bwd", "segsum_packed"))
    runs = {}
    for path, tags in (("sharded_train_jit", ("step tile default",
                                               "step tile exact")),
                       ("gaussian_train_jit", ("step gauss packed16",))):
        def run_path(tags=tags):
            for tag in tags:
                kind, make, _, init, bands, _, _ = steps[tag]
                train = init()
                step = make(make_optimizer(train, TRAIN_LR))
                dstate = densify.init_densify_state(train.num_gaussians, dev)

                def acc(tap, vis):
                    nonlocal dstate
                    dstate = densify.accumulate_grads(dstate, tap, vis)

                caps = graphs.captures[kind]
                res = {}
                res["peak"] = peak_of(lambda: res.update(run=c5.run_steps(
                    step, train, cams, bands, JIT_STEPS, acc)))
                runs[tag] = dict(res, train=train, step=step, dstate=dstate,
                                 captures=graphs.captures[kind] - caps)

        out["counts"][path] = rank_counted(run_path)
        progress(f"path {path}")
    for tag, (kind, _, make_eager, init, bands, mesh, needs) in steps.items():
        c = runs[tag]
        train_e = init()
        step_e = make_eager(make_optimizer(train_e, TRAIN_LR))
        peak_e = peak_of(lambda: c.update(eager=c5.run_steps(
            step_e, train_e, cams, bands, JIT_STEPS)))
        cap_run, e = c["run"], c["eager"]
        differ = c5.differing(c5.run_pairs(cap_run, e))
        nondet = []
        if bool(sh.any_flag(torch.tensor(bool(differ), device=dev), mesh)):
            nondet = nondeterministic_ops(
                lambda: step_e(train_e, [cams[0]], bands[:1]))
        caps = graphs.captures[kind]
        step, train = c["step"], c["train"]
        row, off = replay_report(
            lambda i: step(train, [cams[i % 4]], bands[i % 4:i % 4 + 1]),
            lambda i: step_e(train_e, [cams[i % 4]], bands[i % 4:i % 4 + 1]),
            entry_of(step.graphs), needs, skip)
        row.update(
            bit_identical=not differ, differ=differ, nondeterministic=nondet,
            losses=cap_run["losses"].tolist(), captures=c["captures"],
            recaptured=graphs.captures[kind] - caps,
            steps_ms=dict(eager=dict(host=e["host_ms"], device=e["device_ms"]),
                          replay=dict(host=cap_run["host_ms"],
                                      device=cap_run["device_ms"])),
            peak_bytes=dict(captured=c["peak"], eager=peak_e))
        out["rows"][tag] = row
        if (any(r["overflow"] or not r["finite"] for r in (cap_run, e))
                or c["captures"] != 1
                or row["recaptured"] or off
                or any(not x["within"] for x in differ.values())):
            out["bad"].append(tag)
        trained[tag] = (train, c["dstate"])
        del c["run"], c["eager"], train_e, step_e
        torch.cuda.empty_cache()
        progress(f"{tag} checked")

    # The densify programs: the Gaussian-sharded one on the trained shard,
    # the single-device one on the trained tile-sharded (replicated) scene.
    shard, dstate_g = trained.pop("step gauss packed16")
    whole, dstate_w = trained.pop("step tile default")
    trained.clear()
    runs.clear()
    densify_fn = gt.make_gaussian_sharded_densify(gauss)
    densify_eager = gt.make_eager_gaussian_sharded_densify(gauss)
    programs = {
        "densify gauss": ("gaussian_sharded_densify",
                          lambda: densify_fn(shard, dstate_g),
                          lambda: densify_eager(shard, dstate_g),
                          lambda: densify_fn.graphs),
        "densify single": ("densify",
                           lambda: densify.densify_and_prune_jit(whole,
                                                                 dstate_w),
                           lambda: densify.densify_and_prune(whole, dstate_w),
                           lambda: densify.DENSIFY_GRAPHS)}
    got = {}

    def run_densify():
        for tag, (kind, jit, _, _) in programs.items():
            caps = graphs.captures[kind]
            outs = []
            peak = peak_of(lambda: outs.extend(jit() for _ in range(2)))
            got[tag] = (outs, peak, graphs.captures[kind] - caps)

    out["counts"]["densify_jit"] = rank_counted(run_densify)
    progress("path densify_jit")
    for tag, (kind, jit, eager, cache) in programs.items():
        outs, peak, captured = got.pop(tag)
        want = eager()
        new, fresh, changed, stats = want
        same = []
        for o in outs:
            pairs = {f"scene {f.name}": (getattr(o[0], f.name),
                                         getattr(new, f.name))
                     for f in dataclasses.fields(new)}
            pairs.update({f"state {f.name}": (getattr(o[1], f.name),
                                              getattr(fresh, f.name))
                          for f in dataclasses.fields(fresh)})
            pairs["changed"] = (o[2], changed)
            pairs.update({f"stat {k}": (o[3][k], v) for k, v in stats.items()})
            same.append(not c5.differing(pairs))
        caps = graphs.captures[kind]
        row, off = replay_report(lambda i: jit(), lambda i: eager(),
                                 entry_of(cache()), ())
        row.update(bit_identical=same, captures=captured,
                   recaptured=graphs.captures[kind] - caps, peak_bytes=peak,
                   stats={k: int(v) for k, v in stats.items()})
        out["rows"][tag] = row
        if not all(same) or captured != 1 or row["recaptured"] or off:
            out["bad"].append(tag)
        del outs, want, new, fresh, changed
    del shard, whole, dstate_g, dstate_w
    torch.cuda.empty_cache()

    # fit(mesh=...) on the captured programs, then on the eager ones.
    cfg = RenderConfig(**dict(BENCH, **DEFAULT, max_intersections=cap))
    with torch.no_grad():
        targets = torch.stack([render(scene, c, dataclasses.replace(
            cfg, max_intersections=_bench.CARD["max_intersections"])).image
            for c in cams])
    init = noisy_copy(scene, dev).pad_to(GAUSS_CAPACITY)
    del scene
    kw = dict(steps=MESH_FIT_STEPS, lr=TRAIN_LR, ssim_weight=SSIM_WEIGHT,
              log_every=5, densify_every=MESH_FIT_DENSIFY_AT,
              densify_from=MESH_FIT_DENSIFY_AT,
              densify_until=MESH_FIT_DENSIFY_AT, overflow_policy="raise",
              mesh=grid)
    fits = {}

    def run_fit(tag):
        printed = io.StringIO()
        caps = dict(graphs.captures)
        t0 = time.perf_counter()
        with ctx.redirect_stdout(printed):
            trained_scene, rows = fit(init, cams, targets, cfg, **kw)
        torch.cuda.synchronize()
        fits[tag] = dict(
            wall_s=time.perf_counter() - t0, digest=digest(trained_scene),
            rows=[{k: v for k, v in r.items() if k != "it_per_s"}
                  for r in rows], it_per_s=[r["it_per_s"] for r in rows],
            printed=printed.getvalue(), captures={
                k: graphs.captures[k] - caps.get(k, 0)
                for k in ("sharded_train_step", "densify")})

    progress("densify checked")
    out["counts"]["fit_mesh_jit"] = rank_counted(lambda: run_fit("captured"))
    progress("path fit_mesh_jit")
    make_step, jit_densify = ts.make_sharded_train_step, \
        densify.densify_and_prune_jit
    ts.make_sharded_train_step = ts.make_eager_sharded_train_step
    densify.densify_and_prune_jit = densify.densify_and_prune
    try:
        run_fit("eager")
    finally:
        ts.make_sharded_train_step = make_step
        densify.densify_and_prune_jit = jit_densify
    progress("eager fit")
    fc, fe = fits["captured"], fits["eager"]
    out["rows"]["fit"] = dict(
        rows_equal=fc["rows"] == fe["rows"],
        digests_equal=fc["digest"] == fe["digest"], rows=fc["rows"],
        captures=fc["captures"], eager_captures=fe["captures"],
        wall_s=dict(captured=fc["wall_s"], eager=fe["wall_s"]),
        it_per_s=dict(captured=fc["it_per_s"], eager=fe["it_per_s"]),
        densified=f"'densify_at': {MESH_FIT_DENSIFY_AT}" in fc["printed"]
        if rank == 0 else None)
    f = out["rows"]["fit"]
    if not (f["rows_equal"] and f["digests_equal"]
            and fc["captures"] == {"sharded_train_step": 1, "densify": 1}
            and fe["captures"] == {"sharded_train_step": 0, "densify": 0}
            and f["densified"] in (True, None)
            and f["rows"][-1]["loss"] < f["rows"][0]["loss"]):
        out["bad"].append("fit")
    return out


def check_multi_device_jit(card: str, by_path: dict, cap: int,
                           per_dest: int) -> dict:
    """Phase 20: `rank_multi_device_jit` on JIT_RANKS NCCL ranks sharing
    cuda:0; each path's launches summed over the ranks into by_path, every
    program's row per rank printed. Exits on any rank's failed check."""
    share = check_nccl_share(card)
    res = launch_ranks(rank_multi_device_jit, JIT_RANKS, cap, per_dest,
                       backend="nccl", share_card=True,
                       timeout_s=JIT_LAUNCH_TIMEOUT_S)
    needs = {
        "tile_sharded_jit": ("cull", "raster_fwd", "raster_fwd_packed"),
        "gaussian_sharded_jit": ("cull", "raster_fwd_packed"),
        "sharded_train_jit": ("cull", "raster_fwd", "raster_fwd_packed",
                              "raster_bwd", "raster_bwd_packed", "segsum",
                              "segsum_packed"),
        "gaussian_train_jit": ("cull", "raster_fwd_packed",
                               "raster_bwd_packed", "segsum_packed"),
        "fit_mesh_jit": ("cull", "raster_fwd_packed", "raster_bwd_packed",
                         "segsum_packed"),
        "densify_jit": ()}
    for path, kernels in needs.items():
        counts = sum_counts([{path: r["counts"][path]} for r in res], path)
        by_path[path] = check_counts(path, counts, kernels)
    for r in res:
        for tag, row in r["rows"].items():
            log(f"[multi_device_jit rank {r['rank']} {tag}] "
                f"{json.dumps(row, default=str)}")
    log(f"[multi_device_jit] {JIT_RANKS} NCCL ranks ({res[0]['backend']}) "
        f"sharing cuda:0 on {card}")
    bad = {r["rank"]: r["bad"] for r in res if r["bad"]}
    if bad:
        raise SystemExit(f"multi_device_jit: failed checks per rank {bad}")
    return dict(nccl_share=share, rows={r["rank"]: r["rows"] for r in res})


# ---- phase 21: BASELINE config 5 at its own size ----------------------------
# The config of scripts/probe_config5_memory.py (`config5_memory.CONFIG5`:
# 3840x2048, tile 32, packed binning at K_max 64, packed16, bf16 pairs) on
# `config5_memory.config5_scene`: random_scene seeded 0 with its log-scales
# moved by `LOG_SCALE_SHIFT`, a cut of the workload (each splat half as
# wide, so that no rect passes K_max 64 at 4K and no step overflows). (b)'s
# scene: 6M Gaussians on CONFIG5_RANKS NCCL ranks sharing the card, 3M
# each (N is not cut: a run of `config5_memory --mode ranks` at this size
# peaked at 15.7 GB per rank on an NVIDIA H100 80GB HBM3, 700.00 W, with
# the scales cut or not); its steps, captured and eager. (c): FOURK_N
# random Gaussians at 3840x2160, the bench default with the jumbo tiers to
# FOURK_JUMBO tiles (at 4K random_scene's largest rects pass K_max 64),
# budgets sized by scene_report. (d): the script's own draw (shift 0), not
# a main path: the proxy and the ranks measured, overflow reported.
CONFIG5_N = 6_000_000
CONFIG5_RANKS = 2
CONFIG5_STEPS = 3
CONFIG5_LAUNCH_TIMEOUT_S = 600
FOURK = dict(width=3840, height=2160)
FOURK_N = 2_000_000
FOURK_STEPS = 5
FOURK_JUMBO = 256


def heaviest_tile_row(ranges, tiles_x: int) -> tuple[int, int]:
    """(t0, t1): the tiles of the tile row of `ranges`' grid that holds
    the most intersections."""
    r = ranges.long()
    starts = r[0:-1:tiles_x]
    ends = r[tiles_x::tiles_x]
    k = int((ends - starts[:ends.shape[0]]).argmax())
    return k * tiles_x, (k + 1) * tiles_x


def check_blend_band(tag: str, inputs: dict) -> dict:
    """K1 and K2 on the heaviest tile row of the inputs a path gave
    `raster_tiles_cuda` and `raster_bwd_cuda` (kept by `first_inputs`), at
    that row's tile offset, against the plain walk and re-walk with the
    tolerances of phases 4 and 5 (`check_k1`, `check_k2_inputs`): the plain
    walk is serial, so one row and not the frame. The row's config is the
    one-row band of `local_tile_cfg` (the kernels take the tile count from
    it; the packed streams' quant ranges stay the frame's). Returns the max
    abs errors."""
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg

    missing = [n for n in ("raster_tiles_cuda", "raster_bwd_cuda")
               if n not in inputs]
    if missing:
        raise SystemExit(f"{tag}: no inputs kept for {missing}")
    stream, ranges, c, offset = inputs.pop("raster_tiles_cuda")
    t0, t1 = heaviest_tile_row(ranges, c.tiles_x)
    lo, hi = int(ranges[t0]), int(ranges[t1])
    err1 = check_k1(f"{tag} {c.stream_format} tile row {t0 // c.tiles_x}",
                    stream[:, lo:hi].contiguous(),
                    (ranges[t0:t1 + 1] - lo).contiguous(),
                    local_tile_cfg(c, c.tiles_y), offset + t0)[5]
    del stream
    stream, ranges, g_col, b_total, c, offset, pack = inputs.pop(
        "raster_bwd_cuda")
    t0, t1 = heaviest_tile_row(ranges, c.tiles_x)
    lo, hi = int(ranges[t0]), int(ranges[t1])
    err2 = check_k2_inputs(f"{tag} {c.stream_format} tile row "
                           f"{t0 // c.tiles_x}", (
        stream[:, lo:hi].contiguous(), (ranges[t0:t1 + 1] - lo).contiguous(),
        g_col[t0:t1].contiguous(), b_total[t0:t1].contiguous(),
        local_tile_cfg(c, c.tiles_y), offset + t0, pack))
    return {"k1_max_abs_err": err1, "k2_max_abs_err": err2}


def check_config5_proxy(dev, card: str, by_path: dict) -> dict:
    """(a): `config5_memory`'s proxy at the script's constants (N_SHARD
    Gaussians, 3840x2048, the whole stream capacity of 8.8M). The path,
    counted: the captured step's STEPS + 1 steps (`proxy_run`); after it,
    as many steps of the eager body from a second copy. No overflow, a
    finite loss, the captured step's losses, tap gradients, visibility and
    parameters bit-identical to the eager body's; the memory fields
    printed."""
    cfg = c5.config5_cfg()
    inputs = c5.proxy_inputs(c5.N_SHARD, cfg, dev)
    runs = {}
    by_path["config5_proxy"] = drive(
        "config5_proxy", ("cull", "raster_fwd_packed", "raster_bwd_packed",
                          "segsum_packed"),
        lambda: runs.update(captured=c5.proxy_run(inputs, cfg, True)))
    eager = c5.proxy_run(inputs, cfg, False)
    res = {"memory": runs["captured"]["memory"],
           "eager_memory": eager["memory"],
           "steps": c5.compare_runs(eager, runs["captured"]),
           "kmax_pressure": c5.kmax_pressure(*inputs[:2], cfg),
           "a2a_wire_bytes_analytic": c5.a2a_wire_bytes_analytic()}
    del inputs, runs, eager
    log(f"[config5 proxy] {c5.N_SHARD} Gaussians at {cfg.width}x"
        f"{cfg.height}, capacity {cfg.max_intersections}: "
        f"{json.dumps(res)} on {card}")
    s = res["steps"]
    if not (s["bit_identical"] and s["finite"]) or s["overflow"]:
        raise SystemExit("config5 proxy: overflow, a non-finite loss, or the "
                         f"replays differ from the eager body: {s}")
    return res


def check_config5_script_scene(dev, card: str) -> dict:
    """(d): the script's own draw of the scene (`config5_scene` at shift
    0), measured and not a main path: `config5_memory.proxy` at N_SHARD
    and `config5_memory.ranks` at CONFIG5_N on CONFIG5_RANKS NCCL ranks
    sharing the card (capacities measured at this draw). Rects past K_max
    64 are truncated and flag overflow: reported with the K_max pressure,
    not gated. Fails on a rank's failure, a non-finite loss, replays
    unlike the eager body, or a measured demand past its capacity."""
    import torch

    cfg = c5.config5_cfg()
    out = {"proxy": c5.proxy(c5.N_SHARD, cfg, dev, 0.0)}
    torch.cuda.empty_cache()
    out["ranks"] = c5.ranks(CONFIG5_N, CONFIG5_RANKS, cfg, dev, 0.0)
    caps = out["ranks"]["capacity"]
    log(f"[config5 script scene] shift 0: proxy {json.dumps(out['proxy'])}; "
        f"{CONFIG5_N} Gaussians on {CONFIG5_RANKS} NCCL ranks sharing "
        f"cuda:0: {json.dumps(out['ranks'])} on {card}")
    steps = [out["proxy"]["steps"]] + out["ranks"]["steps"]
    if (not all(s["bit_identical"] and s["finite"] for s in steps)
            or max(max(r) for r in caps["demand"]) > caps["max_intersections"]
            or max(o["max_segment"] for o in caps["occupancy"])
            > caps["per_dest_capacity"]):
        raise SystemExit("config5 script scene: a non-finite loss, replays "
                         "unlike the eager body, or a demand past its "
                         f"capacity: {steps}")
    return out


def config5_reference(dev, card: str, by_path: dict, out_dir: str) -> dict:
    """(b)'s single-device reference, in this process: the CONFIG5_N scene
    at 3840x2048, each of the four views binned at the script's config for
    its intersections; `render_jit` of the four views at 1.15x the largest,
    as a main path; the images saved to out_dir for the ranks; the tied
    (tile, depth) pairs of view 0's stream; the ranks' capacities
    (`config5_memory.measure_capacities`, shard by shard). Frees the card
    before it returns."""
    import torch

    from gsplat_tpu_torch.ops.binning import depth_bits_for
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.render.pipeline import RENDER_GRAPHS, render_jit

    cfg = c5.config5_cfg()
    scene = c5.config5_scene(CONFIG5_N, dev)
    cams = views(cfg.width, cfg.height, dev)
    caps = c5.measure_capacities(scene, cams, cfg, CONFIG5_RANKS)
    single = [sum(row) for row in caps["demand"]]
    cap = int(max(single) * c5.HEADROOM)
    cap += (-cap) % c5.CAP_ALIGN
    rcfg = dataclasses.replace(cfg, max_intersections=cap)
    frames = []
    peak = {}

    def path():
        peak["render"] = peak_of(lambda: frames.extend(
            render_jit(scene, c, rcfg) for c in cams))

    by_path["config5_single"] = drive(
        "config5_single", ("cull", "cull_count", "cull_emit",
                           "raster_fwd_packed"), path)
    ms = timed_calls(lambda i: render_jit(scene, cams[i % 4], rcfg), 4)
    os.makedirs(out_dir, exist_ok=True)
    for i, f in enumerate(frames):
        if bool(f.overflow) or not bool(torch.isfinite(f.image).all()):
            raise SystemExit(f"config5 reference view {i}: overflow or "
                             "non-finite")
        np.save(os.path.join(out_dir, f"ref_{i}.npy"), f.image.cpu().numpy())
    del frames
    RENDER_GRAPHS.entries.clear()
    torch.cuda.empty_cache()
    tied = tied_pairs(scene, cams[0], rcfg)
    # K3's count and emit stages at the scene's own size (N x K_max lanes).
    with torch.no_grad():
        proj = project_gaussians(scene, cams[0], rcfg)
    stages = check_packed_stages(proj, rcfg, "config5 view 0")
    del proj
    out = dict(single_intersections=single, capacity=cap, ms=ms,
               peak_bytes=peak["render"], tied_pairs_view0=tied,
               intersections_view0=single[0], ranks=caps,
               packed_stages=stages)
    log(f"[config5 reference] {CONFIG5_N} Gaussians at {cfg.width}x"
        f"{cfg.height}, one device: intersections per view {single}, "
        f"render_jit at capacity {cap}: {ms} ms, peak {peak['render']} B; "
        f"view 0: {tied} of its adjacent fragment pairs of one tile tie "
        f"at {depth_bits_for(cfg.num_tiles)} depth bits; the ranks' "
        f"per-source capacity "
        f"{caps['max_intersections']}, per-destination "
        f"{caps['per_dest_capacity']} (demand {caps['demand']}, largest "
        f"segments {[o['max_segment'] for o in caps['occupancy']]}) on "
        f"{card}")
    del scene
    torch.cuda.empty_cache()
    return out


def rank_config5(rank: int, caps: dict, ref_dir: str) -> dict:
    """(b) on one of CONFIG5_RANKS NCCL ranks sharing cuda:0: this rank's
    3M rows of the CONFIG5_N scene. The path, counted: the four views
    through `render_gaussian_sharded_jit` (one capture), then CONFIG5_STEPS
    steps of the captured `make_gaussian_sharded_train_step`
    (`config5_memory.sharded_run`, a noisy-DC copy against view 0's
    reference render, ssim_weight 0). After: as many steps of the eager
    body from a second copy, bit-identical; 0 syncs per replay of the frame
    and the step; the kernels on the path's own inputs (every rank's
    first K3 count and emit stages; rank 0's, whose band holds most of the
    fragments, first K1 and K2 on one tile row of the merged packed16 stream and its
    first K5), and on rank 0 the frames against the single-device
    reference (>= GAUSS_RENDER_WITHIN of pixels within rtol 1e-3 / atol
    1e-4, PSNR >= 60 dB)."""
    import torch

    from gsplat_tpu_torch.ops.cuda import cull, raster, segsum
    from gsplat_tpu_torch.parallel import gaussian_sharded as gs
    from gsplat_tpu_torch.parallel.sharding import local_tile_cfg, make_mesh
    from gsplat_tpu_torch.utils import graphs

    dev = rank_setup()
    d = torch.distributed.get_world_size()
    mesh = make_mesh({"gauss": d}, dev)
    cfg = c5.config5_cfg(max_intersections=caps["max_intersections"])
    per_dest = caps["per_dest_capacity"]
    lcfg = local_tile_cfg(cfg, d)
    offset = rank * lcfg.num_tiles
    whole = c5.config5_scene(CONFIG5_N, dev)
    local = gs.shard_scene(whole, mesh)
    init = gs.shard_scene(noisy_copy(whole, dev), mesh)
    del whole
    torch.cuda.empty_cache()
    cams = views(cfg.width, cfg.height, dev)
    ref0 = torch.from_numpy(np.load(os.path.join(ref_dir, "ref_0.npy"))).to(
        dev)
    band = torch.nn.functional.pad(
        ref0, (0, 0, 0, cfg.padded_width - cfg.width, 0,
               cfg.padded_height - cfg.height))[
        rank * lcfg.height:(rank + 1) * lcfg.height][None].contiguous()
    del ref0
    out = {"rank": rank, "tile_offset": offset, "bad": []}
    frames, res, inputs = [], {}, {}
    caps0 = dict(graphs.captures)

    @contextlib.contextmanager
    def keep_inputs():
        with contextlib.ExitStack() as keep:
            for stage in ("cull_count_cuda", "cull_emit_cuda"):
                keep.enter_context(first_inputs(inputs, cull, stage))
            if rank == 0:
                keep.enter_context(first_inputs(
                    inputs, raster, "raster_tiles_cuda",
                    want=lambda *a: a[3] == offset))
                keep.enter_context(first_inputs(
                    inputs, raster, "raster_bwd_cuda",
                    want=lambda *a: a[5] == offset))
                keep.enter_context(first_inputs(
                    inputs, segsum, "segmented_suffix_sum_packed_cuda"))
            yield

    def render(cam):
        return gs.render_gaussian_sharded_jit(local, cam, cfg, mesh,
                                              per_dest_capacity=per_dest)

    def renders():
        with keep_inputs():
            res["render_peak_bytes"] = peak_of(lambda: frames.extend(
                render(c) for c in cams))

    def steps():
        with keep_inputs():
            res["captured"] = c5.sharded_run(cfg, mesh, init, cams[:1], band,
                                             per_dest, CONFIG5_STEPS, True)

    # The path in two counted windows, each around its captured calls
    # alone: the frames' replays for the timing and the sync count run
    # between them, and the frame's graph (its pool) is dropped before the
    # steps.
    counts = rank_counted(renders)
    out["render_ms"] = timed_calls(lambda i: render(cams[i % 4]), 2)
    out["render_syncs"] = count_syncs(lambda: render(cams[0]), 1)
    gs.GAUSSIAN_SHARDED_GRAPHS.entries.clear()
    torch.cuda.empty_cache()
    counts2 = rank_counted(steps)
    out["counts"] = {k: counts[k] + counts2[k] for k in counts}
    out["captures"] = {k: graphs.captures[k] - caps0.get(k, 0)
                       for k in ("render_gaussian_sharded",
                                 "gaussian_sharded_train_step")}
    out["render_peak_bytes"] = res["render_peak_bytes"]
    out["overflow"] = [bool(f[2]) for f in frames]
    out["finite"] = all(bool(torch.isfinite(f[0]).all()) for f in frames)
    captured = res.pop("captured")
    step, train = captured.pop("step"), captured.pop("train")
    out["step_syncs"] = count_syncs(lambda: step(train, cams[:1], band), 1)
    out["wire"] = gs.exchange_bytes(cfg, d, per_dest)
    del res, step, train
    torch.cuda.empty_cache()
    eager = c5.sharded_run(cfg, mesh, init, cams[:1], band, per_dest,
                           CONFIG5_STEPS, False)
    del eager["step"], eager["train"]
    out["steps"] = {"memory": captured["memory"],
                    "eager_memory": eager["memory"],
                    "steps": c5.compare_runs(eager, captured)}
    del captured, eager
    torch.cuda.empty_cache()

    tag = f"config5 rank {rank}"
    check_path_inputs(tag, inputs, ("cull_count_cuda", "cull_emit_cuda") + (
        ("segmented_suffix_sum_packed_cuda",) if rank == 0 else ()))
    if rank == 0:
        out["blend_band"] = check_blend_band(tag + " merged", inputs)
        out["vs_single"] = []
        for i, (img, _, _) in enumerate(frames):
            want = torch.from_numpy(np.load(os.path.join(
                ref_dir, f"ref_{i}.npy"))).to(dev)
            c_img = close_share(img, want, 1e-3, 1e-4)
            db = psnr(img, want)
            out["vs_single"].append(dict(image=c_img, psnr=db))
            if not (c_img["within"] >= GAUSS_RENDER_WITHIN and db >= 60.0):
                out["bad"].append(f"view {i}'s render")
    s = out["steps"]["steps"]
    if (any(out["overflow"]) or not out["finite"] or s["overflow"]
            or not (s["finite"] and s["bit_identical"])
            or out["captures"] != {"render_gaussian_sharded": 1,
                                   "gaussian_sharded_train_step": 1}
            or out["render_syncs"][0] or out["step_syncs"][0]):
        out["bad"].append("the path's gates")
    return out


def check_config5_ranks(card: str, by_path: dict, ref: dict,
                        ref_dir: str) -> list:
    """(b)'s ranks: `rank_config5` on CONFIG5_RANKS NCCL ranks sharing
    cuda:0, the path's launches summed over the ranks; each rank's row
    printed (peak memory, replay and eager ms, the wire's bytes, the
    frames against the reference beside view 0's tied pairs). Exits on a
    rank's failed check."""
    res = launch_ranks(rank_config5, CONFIG5_RANKS, ref["ranks"], ref_dir,
                       backend="nccl", share_card=True,
                       timeout_s=CONFIG5_LAUNCH_TIMEOUT_S)
    counts = sum_counts([{"c": r["counts"]} for r in res], "c")
    by_path["config5_ranks"] = check_counts(
        "config5_ranks", {k: v for k, v in counts.items()
                          if k != "collectives"},
        ("cull", "cull_count", "cull_emit", "raster_fwd_packed",
         "raster_bwd_packed", "segsum_packed"))
    for r in res:
        row = {k: v for k, v in r.items() if k not in ("counts", "bad")}
        log(f"[config5 rank {r['rank']}] {json.dumps(row, default=str)}")
    log(f"[config5] {CONFIG5_N} Gaussians at 3840x2048 on {CONFIG5_RANKS} "
        f"NCCL ranks sharing cuda:0 ({counts['collectives']} collectives): "
        f"per rank peak (captured / eager) "
        f"{[(r['steps']['memory']['peak_memory_in_bytes'], r['steps']['eager_memory']['peak_memory_in_bytes']) for r in res]}"
        f" B, step replay / eager ms "
        f"{[(r['steps']['steps']['replay_ms'], r['steps']['steps']['eager_ms']) for r in res]}"
        f", frame replay ms {[r['render_ms'] for r in res]}; exchange "
        f"bytes per step over the ranks {res[0]['wire']}; view 0's "
        f"single-device stream has {ref['tied_pairs_view0']} tied adjacent "
        f"pairs of {ref['intersections_view0']} fragments; on {card}")
    bad = {r["rank"]: r["bad"] for r in res if r["bad"]}
    if bad:
        raise SystemExit(f"config5 ranks: failed checks per rank {bad}")
    return res


def fourk_cfg(report: dict, n: int, max_intersections: int):
    """(c)'s config: the bench default at FOURK with the jumbo tiers to
    FOURK_JUMBO, each pool tier's divisor and each jumbo budget sized from
    scene_report's members (HEADROOM x, rounded up)."""
    from gsplat_tpu_torch import RenderConfig

    tiers = []
    for (k_hi, div), row in zip(BENCH["tier_spec"], report["tiers"]):
        need = math.ceil(row["members"] * c5.HEADROOM)
        tiers.append((k_hi, 0 if div == 0 else max(n // max(need, 1), 1)))
    jumbo = tuple((t["k_hi"], max(math.ceil(t["members_upper"]
                                            * c5.HEADROOM), 1))
                  for t in report["jumbo"]["tiers"])
    return RenderConfig(**dict(BENCH, **DEFAULT, **FOURK,
                               max_intersections=max_intersections,
                               tier_spec=tuple(tiers),
                               max_tiles_jumbo=FOURK_JUMBO,
                               jumbo_tier_spec=jumbo))


def check_fourk(dev, card: str, by_path: dict) -> dict:
    """(c): the README's single-card claim, FOURK_N random Gaussians at
    3840x2160 on one device. `scene_report` at that shape with the bench's
    ladder and generous jumbo budgets sizes the tiers (`fourk_cfg`); its
    total counts the base ladder alone (the JAX report's rule: the jumbo
    splats' share is the render's), so the stream capacity is 1.15x the
    render's intersections at a generous capacity. The path: `render_jit`
    of view 0 (one capture, then a replay), then FOURK_STEPS steps of the
    captured `make_train_step` (L1 + 0.2 DSSIM) from a noisy-DC copy
    against that render; after, the same steps of the eager body from a
    second copy, bit-identical, and the kernels on the path's own inputs
    (K3's compact and rank stages, K5; K1 and K2 on one tile row). No
    overflow, a finite and falling loss."""
    import io

    import torch

    from gsplat_tpu_torch import Camera, random_scene, render, scene_report
    from gsplat_tpu_torch.ops.cuda import cull, raster, segsum
    from gsplat_tpu_torch.render.pipeline import RENDER_GRAPHS, render_jit
    from gsplat_tpu_torch.train.loop import make_eager_train_step, make_train_step

    n = FOURK_N
    ladder = ",".join(f"{k}:{v}" for k, v in BENCH["tier_spec"])
    argv = ["--scene", "random", "--n", str(n), "--width",
            str(FOURK["width"]), "--height", str(FOURK["height"]),
            "--tile-size", str(BENCH["tile_size"]), "--orbit", "1",
            "--tier-spec", ladder, "--max-tiles-jumbo", str(FOURK_JUMBO),
            "--jumbo-tier-spec", f"128:{n // 16},{FOURK_JUMBO}:{n // 16}",
            "--device", str(dev)]
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed), \
            contextlib.redirect_stderr(io.StringIO()):
        scene_report.main(argv)
    report = json.loads(printed.getvalue())
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    scene = random_scene(n, sh_degree=3, generator=gen, device=dev)
    cam = Camera.default(FOURK["width"], FOURK["height"], device=dev)
    probe = fourk_cfg(report, n, 2 * report["suggested_max_intersections"])
    with torch.no_grad():
        total = int(render(scene, cam, probe).num_intersections)
    cap = int(total * c5.HEADROOM)
    cap += (-cap) % c5.CAP_ALIGN
    cfg = fourk_cfg(report, n, cap)
    log(f"[fourk] scene_report {' '.join(argv)}: tiers "
        f"{[(t['k_lo'], t['k_hi'], t['members']) for t in report['tiers']]}"
        f", base-ladder intersections {report['num_intersections']}, jumbo "
        f"{report['jumbo']}; the render's intersections {total}; sized "
        f"tier_spec {cfg.tier_spec}, jumbo {cfg.jumbo_tier_spec}, capacity "
        f"{cap}")
    res, inputs = {}, {}
    init = noisy_copy(scene, dev)
    target = torch.empty(0)

    def path():
        nonlocal target
        with contextlib.ExitStack() as keep:
            for name in ("cull_compact_cuda", "cull_rank_cuda"):
                keep.enter_context(first_inputs(inputs, cull, name))
            keep.enter_context(first_inputs(inputs, raster,
                                            "raster_tiles_cuda"))
            keep.enter_context(first_inputs(inputs, raster, "raster_bwd_cuda"))
            keep.enter_context(first_inputs(
                inputs, segsum, "segmented_suffix_sum_packed_cuda"))
            frames = []
            res["render_peak_bytes"] = peak_of(lambda: frames.extend(
                render_jit(scene, cam, cfg) for _ in range(2)))
            res["frames_equal"] = bool(torch.equal(frames[0].image,
                                                   frames[1].image))
            res["render_overflow"] = any(bool(f.overflow) for f in frames)
            target = frames[0].image[None].contiguous()
            res["captured"] = c5.fresh_run(
                lambda opt: make_train_step(cfg, opt, SSIM_WEIGHT), init,
                [cam], target, FOURK_STEPS)

    by_path["fourk"] = drive(
        "fourk", ("cull", "cull_rank", "raster_fwd_packed",
                  "raster_bwd_packed", "segsum_packed"), path)
    res["render_ms"] = timed_calls(lambda i: render_jit(scene, cam, cfg), 4)
    cap_run = res.pop("captured")
    del cap_run["step"], cap_run["train"]
    RENDER_GRAPHS.entries.clear()
    torch.cuda.empty_cache()
    eager = c5.fresh_run(lambda opt: make_eager_train_step(cfg, opt,
                                                           SSIM_WEIGHT),
                         init, [cam], target, FOURK_STEPS)
    del eager["step"], eager["train"]
    res["steps"] = c5.compare_runs(eager, cap_run)
    res["memory"], res["eager_memory"] = cap_run["memory"], eager["memory"]
    check_path_inputs("fourk", inputs, (
        "cull_compact_cuda", "cull_rank_cuda",
        "segmented_suffix_sum_packed_cuda"))
    res["blend_band"] = check_blend_band("fourk", inputs)
    log(f"[fourk] {n} Gaussians at {FOURK['width']}x{FOURK['height']}, one "
        f"device: {json.dumps(res)} on {card}")
    s = res["steps"]
    losses = s["losses"]
    del scene, init, target, cap_run, eager
    torch.cuda.empty_cache()
    if (res["render_overflow"] or not res["frames_equal"] or s["overflow"]
            or not (s["finite"] and s["bit_identical"])
            or not losses[-1] < losses[0]):
        raise SystemExit(f"fourk: overflow, a replay unlike its eager body, "
                         f"or a loss not finite and falling: {s}")
    return res


def check_config5(dev, card: str, by_path: dict, kernels: dict) -> dict:
    """Phase 21: (a) the proxy, (b) the CONFIG5_N scene on one device and
    on CONFIG5_RANKS NCCL ranks, (c) FOURK_N Gaussians at 3840x2160 on one
    device; each a main path. Then (d), the script's own draw of the scene
    measured. The kernels' largest errors on the main paths' own inputs go
    to the JSON line's kernels."""
    import torch

    torch.cuda.empty_cache()
    out = {"proxy": check_config5_proxy(dev, card, by_path)}
    ref_dir = os.path.join(HERE, "build", "chip_smoke", "config5")
    out["reference"] = ref = config5_reference(dev, card, by_path, ref_dir)
    try:
        out["ranks"] = check_config5_ranks(card, by_path, ref, ref_dir)
    finally:
        shutil.rmtree(ref_dir, ignore_errors=True)
    out["fourk"] = check_fourk(dev, card, by_path)
    out["script_scene"] = check_config5_script_scene(dev, card)
    band = next(r["blend_band"] for r in out["ranks"] if "blend_band" in r)
    kernels["raster_fwd_packed"].update(
        config5_max_abs_err=band["k1_max_abs_err"],
        fourk_max_abs_err=out["fourk"]["blend_band"]["k1_max_abs_err"])
    kernels["raster_bwd_packed"].update(
        config5_max_abs_err=band["k2_max_abs_err"],
        fourk_max_abs_err=out["fourk"]["blend_band"]["k2_max_abs_err"])
    return out


# ---- Feature 3DGS's blend kernels K6 and K7 (phase 22) ----------------------

# The feature cell of the benchmark (splatbench/), whose 1080p garden view
# phase 22 drives: its configuration, traffic, seed and view.
FEAT_CONFIG = os.path.join(HERE, "splatbench", "configs",
                           "feat3dgs-garden-1m-1080p.json")
FEAT_TRAFFIC = os.path.join(HERE, "splatbench", "traffic", "train-feat.json")
FEAT_SEED = 22
FEAT_VIEW = 11
FEAT_STEPS = 3      # captured train steps of the feature path
# K7 timed again on the table's first channels, to split its time into
# the walk and a slope per channel.
FEAT_SPLIT_CHANNELS = (32, 64, 128)


def heaviest_row_index(ranges, cfg) -> int:
    """The index of the tile row whose tiles hold the most slots (phase
    21's `heaviest_tile_row`, which gives its tiles)."""
    return heaviest_tile_row(ranges, cfg.tiles_x)[0] // cfg.tiles_x


def band_only(g_col, g_tt, g_fm, row: int, cfg):
    """The upstream gradients with every tile outside tile row `row`
    zeroed: (g_colors (T, 3, P), g_trans (T, P), g_fmap (H, W, C))."""
    import torch

    t0, t1 = row * cfg.tiles_x, (row + 1) * cfg.tiles_x
    y0, y1 = row * cfg.tile_size, min(cfg.height, (row + 1) * cfg.tile_size)
    col, tt, fm = (torch.zeros_like(x) for x in (g_col, g_tt, g_fm))
    col[t0:t1], tt[t0:t1], fm[y0:y1] = g_col[t0:t1], g_tt[t0:t1], g_fm[y0:y1]
    return col, tt, fm


def plain_feature_band(stream, ranges, gid, gidk, table, g_col, g_tt, g_fm,
                       row: int, cfg) -> dict:
    """The plain walks of K6 and K7 (`ops/cuda/features.py`'s plain path)
    over tile row `row` alone, on the tensors' device: the row's colour
    (tx, 3, P), transmittance (tx, P) and feature tiles (tx, C, P); the
    slot gradients of the row's slots (9, s1 - s0) and the table's
    gradient (N, C) from the upstream gradients of the whole frame
    (g_colors (T, 3, P), g_trans (T, P), g_fmap (H, W, C)) restricted to
    the row; the slots (s0, s1), the pairs applied and the seconds."""
    import torch

    from gsplat_tpu_torch.ops.binning import NUM_FEATURES
    from gsplat_tpu_torch.ops.cuda.features import _stacked
    from gsplat_tpu_torch.ops.raster_torch import (
        _image_to_tiles,
        _raster_tiles,
        _raster_tiles_bwd_walk,
    )

    t0 = time.perf_counter()
    tx = cfg.tiles_x
    first = row * tx
    band = ranges[first:first + tx + 1]
    s0, s1 = int(band[0]), int(band[-1])
    stacked = _stacked(stream, gid, table, cfg)
    tiles, trans, _ = _raster_tiles(stacked, band, first, cfg)
    fwd_s = time.perf_counter() - t0
    g_all = torch.cat([g_col[first:first + tx],
                       _image_to_tiles(g_fm, cfg)[first:first + tx]], 1)
    b_all = (g_all * tiles).sum(1) + g_tt[first:first + tx] * trans
    dslot, applied = _raster_tiles_bwd_walk(stacked, band, first, g_all,
                                            b_all[..., None], cfg)
    valid = gidk[s0:s1] >= 0
    dtable = torch.zeros_like(table).index_add_(
        0, gid[s0:s1].long()[valid], dslot[NUM_FEATURES:, s0:s1][:, valid].T)
    return dict(colors=tiles[:, :3], trans=trans, fmap=tiles[:, 3:],
                dgeo=dslot[:NUM_FEATURES, s0:s1], dtable=dtable,
                slots=(s0, s1), applied=int(applied), fwd_s=fwd_s,
                bwd_s=time.perf_counter() - t0 - fwd_s)


def compare_features(k: dict, p: dict) -> dict:
    """K6's and K7's outputs on a tile row (`k`, as `plain_feature_band`
    returns them, on the CPU) against the plain walks' (`p`): the colour
    and transmittance within K1's tolerance (PSNR >= 60 dB, >= 99.99% of
    pixels within 1e-4); the feature map's RMSE <= 1e-6 and >= 99.99% of
    pixels within 1e-5 on every channel; the slot gradients and the
    table's gradient each within 1e-5 of the plain walk's largest
    magnitude (the card tests' tolerance). Returns the numbers and "ok"."""
    import torch

    def share(err, tol):
        return float((err <= tol).float().mean())

    err_c = (k["colors"] - p["colors"]).abs().amax(1)
    err_t = (k["trans"] - p["trans"]).abs()
    mse = float(((k["colors"] - p["colors"]) ** 2).mean())
    out = dict(psnr=-10.0 * math.log10(max(mse, 1e-30)),
               color_within=share(err_c, 1e-4), trans_within=share(err_t, 1e-4))
    d = k["fmap"] - p["fmap"]
    out.update(fmap_rmse=float(torch.sqrt((d * d).mean())),
               fmap_max_abs=float(d.abs().max()),
               fmap_within=share(d.abs().amax(1), 1e-5))
    for name in ("dgeo", "dtable"):
        e = (k[name] - p[name]).abs()
        scale = float(p[name].abs().max())
        out[f"{name}_rel_max"] = float(e.max()) / max(scale, 1e-30)
        out[f"{name}_rel_l2"] = float(torch.linalg.vector_norm(
            k[name] - p[name]) / torch.linalg.vector_norm(p[name]).clamp_min(
                1e-30))
    out["ok"] = bool(out["psnr"] >= 60.0 and out["color_within"] >= 0.9999
                     and out["trans_within"] >= 0.9999
                     and out["fmap_rmse"] <= 1e-6
                     and out["fmap_within"] >= 0.9999
                     and out["dgeo_rel_max"] <= 1e-5
                     and out["dtable_rel_max"] <= 1e-5)
    return out


def check_features(dev, card: str, by_path: dict, kernels: dict) -> dict:
    """Phase 22: K6 and K7 (packed4, C = 128) on a 1080p view of the
    benchmark's feature cell (its 1M-Gaussian garden scene and its
    RenderConfig, `FEAT_SEED`, `FEAT_VIEW`). K6's colour and
    transmittance against K1's bit for bit on the whole frame; K6 and K7
    on the heaviest tile row against their plain walks run on CPU copies
    of the same stream (`compare_features`; K7 fed upstream gradients
    zero outside that row, so that its slot gradients outside the row's
    slots must be exactly 0); both timed with CUDA events on the whole
    frame (N(0, 1) upstream gradients) beside K1 and K2 on the same stream
    and beside their bounds from the reference's tally
    (`splatbench/roofline_features.py`), and K7 again on the first
    FEAT_SPLIT_CHANNELS channels of the table, the map and its gradient
    (the walk and the per-channel slope). Then the main path "feat3dgs":
    FEAT_STEPS captured train steps of the cell's step and one
    `render_jit` frame, its launches counted: K6 one a step and a frame,
    K7 one a step, none of them walking its channels in passes
    ("K7.chunked")."""
    import torch

    from gsplat_tpu_torch.models.gaussians import FeatureScene
    from gsplat_tpu_torch.ops.binning import bin_gaussians, features_f32
    from gsplat_tpu_torch.ops.cuda import features as FE
    from gsplat_tpu_torch.ops.cuda import raster
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import _image_to_tiles
    from gsplat_tpu_torch.ops.stream16 import gather_packed
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step
    from splatbench import gen, gen_features, port, roofline_features
    from splatbench.reference import features as ref_features
    from splatbench.reference import render as ref_render

    with open(FEAT_CONFIG) as f:
        config = json.load(f)
    with open(FEAT_TRAFFIC) as f:
        traffic = json.load(f)
    rc, tc, fc = config["render"], config["train"], config["features"]
    cfg = port.render_config(rc)
    fields = gen.make_scene(config, FEAT_SEED, dev)
    n = fields["means"].shape[0]
    fields.update(gen_features.make_feature_fields(config, n, FEAT_SEED, dev))
    views = gen.view_matrices(traffic["poses"])
    cams = [port.camera(v, rc["width"], rc["height"], dev)
            for v in views[FEAT_VIEW:FEAT_VIEW + FEAT_STEPS]]
    table = fields["features"]
    with torch.no_grad():
        proj = project_gaussians(FeatureScene(**fields), cams[0], cfg)
        binned = bin_gaussians(proj, cfg)
        stream = gather_packed(features_f32(proj, cfg), binned.sorted_gid,
                               cfg)
    if bool(binned.overflow):
        raise SystemExit("features: the view overflowed its stream")
    ranges, gid, gidk = binned.ranges, binned.sorted_gid, binned.sorted_gidk
    total = int(binned.num_intersections)
    col, tr, fm = FE.feat_fwd_cuda(stream, ranges, gid, table, cfg)
    k1c, k1t = raster.raster_tiles_cuda(stream, ranges, cfg)
    same_as_k1 = bool(torch.equal(col, k1c) and torch.equal(tr, k1t))
    del k1c, k1t
    gen_t = torch.Generator(device=dev).manual_seed(FEAT_SEED)
    g_col = torch.randn(col.shape, generator=gen_t, device=dev)
    g_tt = torch.randn(tr.shape, generator=gen_t, device=dev)
    g_fm = torch.randn(fm.shape, generator=gen_t, device=dev)
    row = heaviest_row_index(ranges, cfg)
    b_col, b_tt, b_fm = band_only(g_col, g_tt, g_fm, row, cfg)
    dgeo, dtab = FE.feat_bwd(stream, ranges, gid, gidk, table, b_col, col,
                             b_tt, tr, b_fm, fm, cfg)
    plain = plain_feature_band(
        *[x.cpu() for x in (stream, ranges, gid, gidk, table, b_col, b_tt,
                            b_fm)], row, cfg)
    s0, s1 = plain["slots"]
    first, tx = row * cfg.tiles_x, cfg.tiles_x
    kern = dict(colors=col[first:first + tx].cpu(),
                trans=tr[first:first + tx].cpu(),
                fmap=_image_to_tiles(fm, cfg)[first:first + tx].cpu(),
                dgeo=dgeo[:, s0:s1].cpu(), dtable=dtab.cpu())
    outside = int((dgeo[:, :s0] != 0).sum() + (dgeo[:, s1:] != 0).sum())
    res = compare_features(kern, plain)
    log(f"[K6/K7 garden 1080p] {n} Gaussians, {total} intersections, view "
        f"{FEAT_VIEW}; K6's colour and transmittance K1's bit for bit: "
        f"{same_as_k1}; tile row {row} (slots {s0}..{s1}, {plain['applied']} "
        f"pairs applied) against the plain walks on the CPU "
        f"({plain['fwd_s']} s forward, {plain['bwd_s']} s backward): {res}; "
        f"K7's slot gradients outside the row nonzero: {outside}")
    if not (same_as_k1 and res["ok"] and outside == 0):
        raise SystemExit("K6/K7: kernel outside the stated tolerance of the "
                         "plain walks, or K6's colour not K1's")
    plain_s = dict(feat_fwd=plain["fwd_s"], feat_bwd=plain["bwd_s"])
    del plain, kern, dgeo, dtab, b_col, b_tt, b_fm
    b_total = ((g_col * col).sum(1) + g_tt * tr).contiguous()
    ms = dict(
        feat_fwd=cuda_ms(lambda: FE.feat_fwd_cuda(stream, ranges, gid, table,
                                                  cfg), 20),
        feat_bwd=cuda_ms(lambda: FE.feat_bwd_cuda(
            stream, ranges, gid, table, g_col, b_total, g_fm, fm, cfg), 20),
        K1=cuda_ms(lambda: raster.raster_tiles_cuda(stream, ranges, cfg), 20),
        K2=cuda_ms(lambda: raster.raster_bwd_cuda(
            stream, ranges, g_col, b_total, cfg, pack_out=True), 20))
    by_channels = {}
    for c in FEAT_SPLIT_CHANNELS:
        part = [x[..., :c].contiguous() for x in (table, g_fm, fm)]
        by_channels[c] = cuda_ms(lambda: FE.feat_bwd_cuda(
            stream, ranges, gid, part[0], g_col, b_total, part[1], part[2],
            cfg), 20)
        del part
    log(f"[feat_bwd] ms by channels on the same stream: {by_channels}")
    del col, tr, fm, g_col, g_tt, g_fm, b_total, stream, proj, binned
    torch.cuda.empty_cache()
    tally = {}
    rcam = ref_render.camera(views[FEAT_VIEW], rc["width"], rc["height"], dev)
    ref_features.render(fields, rcam, rc, tally=tally)
    torch.cuda.empty_cache()
    for name, work, alone in (
            ("feat_fwd", roofline_features.k6_work(tally, rc, n), "K1"),
            ("feat_bwd", roofline_features.k7_work(tally, rc, n), "K2")):
        ops, n_bytes = work
        bound_ms, bound_by = bound(n_bytes, ops)
        kernels[name].update(
            ms=ms[name], bound_ms=bound_ms, bound_by=bound_by,
            roofline_pct=100.0 * bound_ms / ms[name], library_ms=None,
            plain_cpu_row_s=plain_s[name], max_rel_err=res[
                "fmap_max_abs" if name == "feat_fwd" else "dtable_rel_max"],
            **{f"{alone}_ms": ms[alone]})
        log(f"[{name}] {ms[name]} ms ({alone} on the same stream "
            f"{ms[alone]} ms), bound {bound_ms} ms ({bound_by}: {ops} ops, "
            f"{n_bytes} B): {100.0 * bound_ms / ms[name]}% of it; plain "
            f"walk of one tile row on the CPU {plain_s[name]} s; {card}")
    kernels["feat_bwd"]["ms_by_channels"] = by_channels

    # The main path: the cell's captured train step, then a frame.
    targets = gen.make_targets(traffic["targets"], len(views), rc["height"],
                               rc["width"], FEAT_SEED, dev,
                               range(FEAT_VIEW, FEAT_VIEW + FEAT_STEPS))
    teachers = gen_features.make_teachers(
        traffic["teachers"], len(views), config, FEAT_SEED, dev,
        range(FEAT_VIEW, FEAT_VIEW + FEAT_STEPS))
    scene = FeatureScene(**fields)

    def feature_path():
        opt = make_optimizer(scene, lr=tc["lr"], feature_lr=fc["lr"],
                             decoder_lr=fc["decoder_lr"])
        step = make_train_step(cfg, opt, ssim_weight=tc["ssim_weight"],
                               feature_weight=fc["gamma"])
        for i in range(FEAT_STEPS):
            loss, aux, _ = step(scene, [cams[i]], targets[i:i + 1],
                                tc["active_sh_degree"],
                                teachers=teachers[i:i + 1])
            log(f"[feat3dgs] step {i}: loss {float(loss)}, overflow "
                f"{bool(aux['overflow'])}, grads finite "
                f"{bool(aux['grads_finite'])}")
            if bool(aux["overflow"]) or not bool(aux["grads_finite"]) or \
                    not math.isfinite(float(loss)):
                raise SystemExit(f"feat3dgs: step {i} overflowed or went "
                                 "non-finite")
        out = render_jit(scene, cams[0], cfg)
        if bool(out.overflow) or not bool(torch.isfinite(out.features).all()):
            raise SystemExit("feat3dgs: render_jit's frame failed")

    by_path["feat3dgs"] = counts = drive("feat3dgs", ("feat_fwd", "feat_bwd"),
                                         feature_path)
    log(f"[feat3dgs] K7 launches walking their channels in passes "
        f"(K7.chunked): {counts['feat_bwd_chunked']}")
    if counts["feat_fwd"] != FEAT_STEPS + 1 or \
            counts["feat_bwd"] != FEAT_STEPS or counts["feat_bwd_chunked"]:
        raise SystemExit(f"feat3dgs: K6 launched {counts['feat_fwd']} and K7 "
                         f"{counts['feat_bwd']} times ("
                         f"{counts['feat_bwd_chunked']} in passes) for "
                         f"{FEAT_STEPS} steps and a frame")
    del scene, fields, targets, teachers, table
    torch.cuda.empty_cache()
    return res


# ---- the projection kernels K8 and K9 (phase 23) ----------------------------

# The cells whose scene and first view phase 23 projects: bicycle's 6M-
# Gaussian 4K frame and garden's 1M-Gaussian 1080p step.
PROJECT_CELLS = (("bicycle-6m-4k", "render.json"),
                 ("garden-1m-1080p", "train.json"))
PROJECT_SEED = 23
# K8 against the plain version on the card: the integer outputs (mask,
# rect, counts; and radius, a ceil) equal on PROJECT_INT_SHARE of the
# Gaussians and overflow equal; each float output bit-equal on
# PROJECT_BIT_SHARE of its elements, the rest at most PROJECT_ULPS apart.
PROJECT_INT_SHARE = 0.9999
PROJECT_BIT_SHARE = 0.999
PROJECT_ULPS = 2
PROJECT_INT_FIELDS = ("mask", "rect", "counts", "radius")
PROJECT_FLOAT_FIELDS = ("uv", "conic", "depth", "color", "opacity")
# K9 against autograd of the plain version: the scene-gradient tolerance,
# on PROJECT_GRAD_SHARE of each field's entries.
PROJECT_RTOL, PROJECT_ATOL = 5e-3, 1e-5
PROJECT_GRAD_SHARE = 0.9999
# Bytes a Gaussian at SH degree 3. K8 reads means 12, log-scales 12, the
# quaternion 16, the opacity logit 4 and SH 192, and writes uv 8, conic
# 12, depth 4, colour 12, opacity 4, radius 4, rect 16, count 4 and the
# mask 1; K9 reads the same 236, the 36 of upstream gradients (uv 8, conic
# 12, colour 12, opacity 4), and writes 236 of gradients.
K8_BYTES = 236 + 65
K9_BYTES = 236 + 36 + 236
# FP32 operations a Gaussian, counted from the source (csrc/project.cu):
# K8 about 400, K9 about 1000 (the forward again and its chain). Far
# below the bytes on this card either way.
K8_OPS, K9_OPS = 400, 1000


def projection_edge_camera(device):
    """The camera of `projection_edge_scene`: at the origin, looking down
    +z, 64x48 pixels, focal (60, 50)."""
    from gsplat_tpu_torch.ops.camera import Camera, look_at

    return Camera.create(look_at((0.0, 0.0, 0.0), (0.0, 0.0, 1.0)), 64, 48,
                         60.0, 50.0, device=device)


def projection_edge_config(**kw):
    """The RenderConfig of `projection_edge_scene`: K_max 16, so that its
    largest splats overflow."""
    from gsplat_tpu_torch import RenderConfig

    return RenderConfig(**dict(dict(
        width=64, height=48, tile_size=8, max_intersections=1 << 14,
        max_tiles_per_gaussian=16, block_size=8, max_per_tile=256), **kw))


# The groups of `projection_edge_scene`, in order.
EDGE_GROUPS = ("visible", "behind", "before_near", "outside", "faint",
               "dark", "degenerate", "huge")


def projection_edge_scene(device, per_group: int = 16, seed: int = 0):
    """An SH-3 scene that reaches every branch of the projection from
    `projection_edge_camera`, `per_group` Gaussians a group (EDGE_GROUPS):
    visible ones; behind the camera; between it and the near plane;
    outside the frustum (|x / z| from 1.5 to 3, so that the txy clamp
    bites);
    opacity under alpha_min (logit -8); colour below 0 (SH DC -3, the
    rest 0); zero
    covariance (log-scales -60: exp(-60)^2 rounds to 0 in float32, so det
    is 0 at a zero low-pass); rects past K_max (scale 0.5); and two
    Gaussians at the camera's centre (a zero view direction)."""
    import torch

    from gsplat_tpu_torch.models.gaussians import GaussianScene

    rng = np.random.default_rng(seed)
    k = per_group

    def block(z_lo, z_hi, spread):
        z = rng.uniform(z_lo, z_hi, k)
        xy = rng.uniform(-1.0, 1.0, (k, 2)) * spread * np.abs(z)[:, None]
        return np.column_stack([xy, z])

    spans = dict(visible=(2, 6, 0.3), behind=(-3, -0.5, 0.3),
                 before_near=(0.01, 0.19, 0.3), outside=(2, 6, 1.0),
                 faint=(2, 6, 0.3), dark=(2, 6, 0.3), degenerate=(2, 6, 0.3),
                 huge=(2, 6, 0.2))
    means = np.concatenate([block(*spans[g]) for g in EDGE_GROUPS]
                           + [np.zeros((2, 3))])
    n = means.shape[0]
    at = {g: slice(i * k, (i + 1) * k) for i, g in enumerate(EDGE_GROUPS)}
    out = means[at["outside"]]  # |x / z| in [1.5, 3]: off every frustum
    out[:, 0] = np.sign(out[:, 0]) * rng.uniform(1.5, 3.0, k) * out[:, 2]
    log_scales = rng.uniform(-4.5, -2.5, (n, 3))
    logits = rng.uniform(-1.0, 3.0, n)
    sh = rng.normal(0.0, 0.3, (n, 16, 3))
    sh[:, 0] = rng.uniform(0.0, 2.0, (n, 3))
    logits[at["faint"]] = -8.0
    sh[at["dark"], 0] = -3.0
    sh[at["dark"], 1:] = 0.0
    log_scales[at["degenerate"]] = -60.0
    log_scales[at["huge"]] = np.log(0.5)
    return GaussianScene(*(
        torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)
        for x in (means, log_scales, rng.normal(size=(n, 4)), logits, sh)))


def float_ulps(a, b):
    """Per element, how many float32 steps apart a and b are (0 where
    both are NaN; -0 and +0 are 0 apart)."""
    import torch

    def key(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    d = (key(a) - key(b)).abs()
    return torch.where(torch.isnan(a) & torch.isnan(b), torch.zeros_like(d),
                       d)


def compare_projected(k, p) -> dict:
    """K8's ProjectedGaussians `k` against the plain version's `p`: the
    share of Gaussians whose integer outputs are equal, each float output's
    share of bit-equal elements and largest distance in ulps, whether
    overflow agrees, and `ok` where all are within PROJECT_*."""
    out = {}
    for f in PROJECT_INT_FIELDS:
        a, b = getattr(k, f), getattr(p, f)
        eq = (a == b) | ((a != a) & (b != b))  # NaN radii agree
        out[f] = float((eq.all(-1) if eq.dim() > 1 else eq).float().mean())
    out["overflow"] = bool(k.overflow) == bool(p.overflow)
    for f in PROJECT_FLOAT_FIELDS:
        d = float_ulps(getattr(k, f), getattr(p, f))
        out[f] = float((d == 0).float().mean())
        out[f"{f}_ulps"] = int(d.max())
    out["ok"] = (out["overflow"]
                 and all(out[f] >= PROJECT_INT_SHARE
                         for f in PROJECT_INT_FIELDS)
                 and all(out[f] >= PROJECT_BIT_SHARE
                         and out[f"{f}_ulps"] <= PROJECT_ULPS
                         for f in PROJECT_FLOAT_FIELDS))
    return out


def compare_projection_grads(got, want, exact=None) -> dict:
    """K9's gradients against autograd's, per scene field: the share of
    entries within PROJECT_ATOL + PROJECT_RTOL |want|, the largest
    |got - want| / (PROJECT_ATOL + PROJECT_RTOL |want|), non-finite
    entries; with `exact` (autograd in float64), each one's share within
    the same tolerance of it. `ok` where every field's share is at least
    PROJECT_GRAD_SHARE and every entry finite."""
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS

    def ratio(a, b):
        b = b.to(a.dtype)
        return ((a - b).abs() / (PROJECT_ATOL + PROJECT_RTOL * b.abs())
                ).nan_to_num(float("inf"))

    out = {}
    for i, (f, a, b) in enumerate(zip(SCENE_FIELDS, got, want)):
        r = ratio(a, b)
        out[f] = dict(within=float((r <= 1).float().mean()),
                      worst=float(r.max()),
                      nonfinite=int((~a.isfinite()).sum()))
        if exact is not None:
            for who, x in (("kernel", a), ("autograd", b)):
                out[f][f"{who}_exact"] = float(
                    (ratio(x, exact[i]) <= 1).float().mean())
    out["ok"] = all(v["within"] >= PROJECT_GRAD_SHARE and v["nonfinite"] == 0
                    for v in out.values())
    return out


def project_cell(name: str, traffic: str, dev):
    """A benchmark cell's scene (seed PROJECT_SEED), its first view's
    camera, its RenderConfig, and its config and traffic."""
    from splatbench import gen, port

    bench_dir = os.path.join(HERE, "splatbench")
    with open(os.path.join(bench_dir, "configs", f"{name}.json")) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic", traffic)) as f:
        traffic = json.load(f)
    rc = config["render"]
    view = gen.view_matrices(traffic["poses"])[0]
    return (port.scene(gen.make_scene(config, PROJECT_SEED, dev)),
            port.camera(view, rc["width"], rc["height"], dev),
            port.render_config(rc), config, traffic)


def float64_grads(fields, cam, cfg, upstream):
    """Autograd of `_project_plain` in float64 (scene, camera and upstream
    gradients widened): the exact chain's reference for K9 and for
    autograd in float32."""
    import dataclasses as dc

    import torch

    from gsplat_tpu_torch.models.gaussians import GaussianScene
    from gsplat_tpu_torch.ops import projection as P

    leaves = [t.detach().double().requires_grad_(True) for t in fields]
    cam64 = dc.replace(cam, **{f.name: getattr(cam, f.name).double()
                               for f in dc.fields(cam)})
    q = P._project_plain(GaussianScene(*leaves), cam64, cfg)
    return torch.autograd.grad([q.uv, q.conic, q.color, q.opacity], leaves,
                               [g.double() for g in upstream])


def check_project_kernels(tag, scene, cam, cfg, dev) -> dict:
    """K8 and K9 on one scene and view against the plain versions on the
    card: K8's outputs (`compare_projected`), K9's gradients for N(0, 1)
    upstream gradients against autograd of `_project_plain`, and both
    against its float64 autograd (`compare_projection_grads`), K9 again
    with the upstream gradients zero outside the mask (zeros there, the
    first call's bits elsewhere); K8, K9 and the plain versions timed."""
    import torch

    from gsplat_tpu_torch.models.gaussians import GaussianScene
    from gsplat_tpu_torch.ops import projection as P
    from gsplat_tpu_torch.ops.cuda import project as K

    fields = tuple(getattr(scene, f.name)
                   for f in dataclasses.fields(GaussianScene))
    cam_t = tuple(getattr(cam, f) for f in K.CAMERA_FIELDS)
    degree = P.sh_degree(scene, cfg)
    n = scene.num_gaussians
    with torch.no_grad():
        k = P.project_gaussians(scene, cam, cfg)
        p, plain_fwd_ms = timed_once(lambda: P._project_plain(scene, cam, cfg))
    fwd = compare_projected(k, p)
    mask = k.mask
    del k, p
    gen_t = torch.Generator(device=dev).manual_seed(PROJECT_SEED)
    g = [torch.randn(shape, generator=gen_t, device=dev)
         for shape in ((n, 2), (n, 3), (n, 3), (n,))]
    leaves = [t.detach().clone().requires_grad_(True) for t in fields]
    q = P._project_plain(GaussianScene(*leaves), cam, cfg)
    want, plain_bwd_ms = timed_once(lambda: torch.autograd.grad(
        [q.uv, q.conic, q.color, q.opacity], leaves, g))
    del q, leaves
    exact = float64_grads(fields, cam, cfg, g)
    got = K.project_bwd_cuda(fields, cam_t, cfg, degree, *g)
    bwd = compare_projection_grads(got, want, exact)
    del want, exact
    masked = [torch.where(mask.view(-1, *([1] * (x.dim() - 1))), x,
                          torch.zeros_like(x)) for x in g]
    got_m = K.project_bwd_cuda(fields, cam_t, cfg, degree, *masked)
    zero_rows = all(bool((x[~mask] == 0).all()) for x in got_m)
    same_rows = all(bool(torch.equal(x[mask], y[mask]))
                    for x, y in zip(got_m, got))
    del got, got_m, masked
    ms = dict(
        K8=cuda_ms(lambda: K.project_fwd_cuda(fields, None, cam_t, cfg,
                                              degree), 20),
        K9=cuda_ms(lambda: K.project_bwd_cuda(fields, cam_t, cfg, degree,
                                              *g), 20))
    bounds = dict(K8=bound(n * K8_BYTES, n * K8_OPS),
                  K9=bound(n * K9_BYTES, n * K9_OPS))
    row = dict(n=n, fwd=fwd, bwd=bwd, zero_rows=zero_rows,
               same_rows=same_rows, ms=ms,
               bound_ms={k: b[0] for k, b in bounds.items()},
               plain_fwd_ms=plain_fwd_ms, plain_bwd_ms=plain_bwd_ms,
               visible=int(mask.sum()))
    log(f"[K8/K9 {tag}] {json.dumps(row)}")
    if not (fwd["ok"] and bwd["ok"] and zero_rows and same_rows):
        raise SystemExit(f"K8/K9 {tag}: kernel outside the stated tolerance "
                         "of the plain version, or K9 not zero on the rows "
                         "without upstream gradients")
    return row


def check_projection(dev, card: str, by_path: dict, kernels: dict) -> dict:
    """Phase 23: K8 and K9 (`check_project_kernels`) on bicycle's 6M scene
    and its first view (3840x2048) and on garden's 1M scene and its first
    view (1920x1080), the benchmark cells' configurations; then the main
    path "project": bicycle's captured frame (`render_jit`, 2 calls) and
    garden's captured train step (the cell's recipe, 2 steps), counted:
    one K8 a frame or step, one K9 a step; the graphs' nodes by type at
    capture."""
    import torch

    from gsplat_tpu_torch.render import pipeline
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step
    from splatbench import gen

    rows, cells = {}, {}
    for name, traffic in PROJECT_CELLS:
        scene, cam, cfg, config, tr = project_cell(name, traffic, dev)
        rows[name] = check_project_kernels(name, scene, cam, cfg, dev)
        cells[name] = (scene, cam, cfg, config, tr)
        torch.cuda.empty_cache()
    for kname, key, bytes_ in (("project_fwd", "K8", K8_BYTES),
                               ("project_bwd", "K9", K9_BYTES)):
        kernels[kname].update(
            ms={c: r["ms"][key] for c, r in rows.items()},
            bound_ms={c: r["bound_ms"][key] for c, r in rows.items()},
            bound_by="bytes", library_ms=None,
            plain_ms={c: r["plain_fwd_ms" if key == "K8" else "plain_bwd_ms"]
                      for c, r in rows.items()},
            bytes_per_gaussian=bytes_)

    bscene, bcam, bcfg, _, _ = cells["bicycle-6m-4k"]
    gscene, gcam, gcfg, gconfig, gtr = cells["garden-1m-1080p"]
    tc = gconfig["train"]
    targets = gen.make_targets(gtr["targets"], 1, gcfg.height, gcfg.width,
                               PROJECT_SEED, dev, range(1))
    nodes = {}

    def path():
        for _ in range(2):
            out = pipeline.render_jit(bscene, bcam, bcfg)
        nodes["frame"] = next(reversed(
            pipeline.RENDER_GRAPHS.entries.values())).nodes
        opt = make_optimizer(gscene, lr=tc["lr"])
        step = make_train_step(gcfg, opt, ssim_weight=tc["ssim_weight"])
        for _ in range(2):
            loss, aux, _ = step(gscene, [gcam], targets,
                                tc["active_sh_degree"])
        (entry,) = step.graphs.entries.values()
        nodes["step"] = entry.nodes
        if bool(out.overflow) or bool(aux["overflow"]) or not (
                bool(aux["grads_finite"]) and math.isfinite(float(loss))):
            raise SystemExit("project: the frame or the step overflowed or "
                             "went non-finite")

    by_path["project"] = counts = drive("project",
                                        ("project_fwd", "project_bwd"), path)
    log(f"[project] nodes at capture: garden step {nodes['step']}, bicycle "
        f"frame {nodes['frame']}; {card}")
    if counts["project_fwd"] != 4 or counts["project_bwd"] != 2:
        raise SystemExit(f"project: K8 launched {counts['project_fwd']} and "
                         f"K9 {counts['project_bwd']} times for 2 frames and "
                         "2 steps")
    del cells, bscene, gscene, targets
    torch.cuda.empty_cache()
    return dict(rows=rows, nodes=nodes)


# ---- 2D Gaussian splatting's K10-K13 (phase 24) -----------------------------

# The benchmark's surfel cell phase 24 drives: its configuration, traffic,
# seed and view (the first).
SURF_CONFIG = os.path.join(HERE, "splatbench", "configs",
                           "2dgs-garden-1m-1080p.json")
SURF_TRAFFIC = os.path.join(HERE, "splatbench", "traffic",
                            "train-2dgs.json")
SURF_SEED = 24
SURF_VIEW = 0
SURF_STEPS = 3      # captured train steps of the surfel path
# K12 against the plain version: the depth bit-equal; mask, rect and
# counts equal on SURF_INT_SHARE of the surfels; the differentiable
# outputs, and uv and conic where the plain version keeps the surfel,
# within SURF_ATOL + SURF_RTOL |plain|. K13 against autograd of the plain
# version: PROJECT_RTOL / PROJECT_ATOL on PROJECT_GRAD_SHARE of each
# field's entries (`compare_projection_grads`).
SURF_INT_SHARE = 0.9999
SURF_RTOL, SURF_ATOL = 2e-5, 1e-5
# K10's maps on a tile row against the plain walk of each of its tiles:
# each map's largest difference within SURF_MAP_TOL of max(1, the plain
# map's largest magnitude) (a pixel whose transmittance lands on t_min
# within a rounding may stop one pair apart in the two walks). K11 with
# K4's sums: each table column's gap of norms to autograd within
# SURF_GRAD_TOL, the centre's two columns within SURF_CENTRE_TOL (they
# take gradient only where the filter wins, on a few pairs of a 1080p row,
# so a few sums with cancelling terms carry them).
SURF_MAP_TOL = 2e-4
SURF_GRAD_TOL = 1e-4
SURF_CENTRE_TOL = 1e-2
# The 3DGS kernels, which no surfel path launches.
GAUSSIAN_KERNELS = ("raster_fwd", "raster_fwd_packed", "raster_bwd",
                    "raster_bwd_packed", "segsum_packed", "feat_fwd",
                    "feat_bwd", "project_fwd", "project_bwd")


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def compare_surfel_projection(k, p) -> dict:
    """K12's ProjectedSurfels `k` against the plain version's `p`: whether
    the depths are the same bits and the overflow flags agree, the share
    of surfels whose mask, rect and counts are equal, each float output's
    largest |k - p| / (SURF_ATOL + SURF_RTOL |p|) (uv and conic where `p`
    keeps the surfel), and `ok` where all are within SURF_*."""
    import torch

    from gsplat_tpu_torch.ops import surfels as S

    out = dict(depth=torch.equal(k.depth, p.depth),
               overflow=bool(k.overflow) == bool(p.overflow))
    for f in ("mask", "rect", "counts"):
        eq = getattr(k, f) == getattr(p, f)
        out[f] = float((eq.all(-1) if eq.dim() > 1 else eq).float().mean())
    for f in S.SURFEL_OUTPUTS + ("uv", "conic"):
        a, b = getattr(k, f), getattr(p, f)
        if f in ("uv", "conic"):
            a, b = a[p.mask], b[p.mask]
        r = ((a - b).abs() / (SURF_ATOL + SURF_RTOL * b.abs())).nan_to_num(
            float("inf"))
        out[f"{f}_worst"] = float(r.max()) if r.numel() else 0.0
    out["ok"] = bool(out["depth"] and out["overflow"]
                     and all(out[f] >= SURF_INT_SHARE
                             for f in ("mask", "rect", "counts"))
                     and all(v <= 1.0 for f, v in out.items()
                             if f.endswith("_worst")))
    return out


def row_only(grads, row: int, cfg):
    """The five maps' gradients (H, W, ...) with every pixel outside tile
    row `row` zeroed."""
    import torch

    y0 = row * cfg.tile_size
    y1 = min(cfg.height, y0 + cfg.tile_size)
    out = [torch.zeros_like(g) for g in grads]
    for o, g in zip(out, grads):
        o[y0:y1] = g[y0:y1]
    return out


def plain_surfel_row(table, gid, ranges, grads, row: int, cfg) -> dict:
    """The plain walk (`ops/surfels.py::_walk_plain`) of each tile of tile
    row `row` alone, on the tensors' device: the row's five maps (image,
    trans, normal sum, depth sum, distortion), each (y1 - y0, W, k); the
    table's gradient (N, 18) by autograd from the five maps' gradients
    `grads` (H, W, ...) on the row; the forward's and the backward's
    seconds."""
    import torch

    from gsplat_tpu_torch.ops import surfels as S

    dev = table.device
    ts = cfg.tile_size
    y0 = row * ts
    y1 = min(cfg.height, y0 + ts)
    leaf = table.detach().clone().requires_grad_(True)
    dtable = torch.zeros_like(table)
    maps = [torch.zeros((y1 - y0, cfg.width) + tuple(g.shape[2:]),
                        device=dev) for g in grads]
    fwd_s = bwd_s = 0.0
    for tx in range(cfg.tiles_x):
        t = row * cfg.tiles_x + tx
        _sync(dev)
        t0 = time.perf_counter()
        planes = S._walk_plain(leaf, gid, ranges[t:t + 2], cfg,
                               tile_offset=t)
        _sync(dev)
        fwd_s += time.perf_counter() - t0
        ys = torch.arange(ts, device=dev)[:, None] + y0
        xs = torch.arange(ts, device=dev)[None, :] + tx * ts
        inside = ((ys < cfg.height) & (xs < cfg.width)).reshape(-1)
        yy = ys.clamp_max(cfg.height - 1).expand(ts, ts).reshape(-1)[inside]
        xx = xs.clamp_max(cfg.width - 1).expand(ts, ts).reshape(-1)[inside]
        loss = 0.0
        for plane, g, m in zip(planes, grads, maps):
            k = plane.shape[-1]
            mine = plane[0][inside]
            m[yy - y0, xx] = mine.detach().reshape((-1,) + m.shape[2:])
            loss = loss + (mine * g[yy, xx].reshape(-1, k)).sum()
        if not (torch.is_tensor(loss) and loss.requires_grad):
            continue  # a tile with no slot
        t0 = time.perf_counter()
        (d,) = torch.autograd.grad(loss, leaf, allow_unused=True)
        if d is not None:
            dtable += d
        _sync(dev)
        bwd_s += time.perf_counter() - t0
    return dict(maps=maps, dtable=dtable, rows=(y0, y1), fwd_s=fwd_s,
                bwd_s=bwd_s)


def compare_surfel_row(outs, dtable, plain: dict) -> dict:
    """K10's maps `outs` (the whole frame's) on the row and the table's
    gradient `dtable` (K11 and K4 from the row's upstream gradients)
    against `plain_surfel_row`'s: each map's largest difference over
    max(1, the plain map's largest magnitude), each table column's gap of
    norms, and `ok` where they are within SURF_MAP_TOL, SURF_GRAD_TOL and
    (the centre's columns) SURF_CENTRE_TOL."""
    import torch

    from gsplat_tpu_torch.ops import surfels as S

    y0, y1 = plain["rows"]
    maps = [float((o[y0:y1] - m).abs().max())
            / max(1.0, float(m.abs().max()))
            for o, m in zip(outs, plain["maps"])]
    want = plain["dtable"]
    gap = ((dtable - want).norm(dim=0)
           / want.norm(dim=0).clamp_min(1e-12)).tolist()
    centre = (S.TAB_C, S.TAB_C + 1)
    rest = [g for i, g in enumerate(gap) if i not in centre]
    out = dict(maps=maps, columns=gap)
    out["ok"] = bool(max(maps) <= SURF_MAP_TOL and max(rest) <= SURF_GRAD_TOL
                     and max(gap[i] for i in centre) <= SURF_CENTRE_TOL
                     and bool(torch.isfinite(dtable).all()))
    return out


def check_surfels(dev, card: str, by_path: dict, kernels: dict) -> dict:
    """Phase 24: K12, K13, K10 and K11 on the first view of the benchmark's
    surfel cell (its 1M garden surfels, RenderConfig and seed SURF_SEED,
    1920x1080). K12 against `_project_surfels_plain` on the card
    (`compare_surfel_projection`); K13 for N(0, 1) upstream gradients
    against autograd of the plain version (`compare_projection_grads`);
    on the heaviest tile row, K10's maps and the table's gradient of K11
    and K4 (upstream gradients N(0, 1) on the row, zero elsewhere) against
    the plain walk of each tile (`plain_surfel_row`,
    `compare_surfel_row`), and K11's slot gradients outside the row's
    slots 0; the four kernels timed with CUDA events (K10 and K11 on the
    whole frame) beside the plain versions (the projection's on the whole
    frame, the walk's on the row) and beside their bounds from the
    reference's tally of the view (`splatbench/roofline_surfels.py`).
    Then the main path "surfels": SURF_STEPS captured train steps of the
    cell's step and one `render_jit` frame, its launches counted from 0:
    K12 and K10 once a step and a frame, K13 and K11 once a step, K4 twice
    a step (the gather backward's two passes of 9 rows), none of
    GAUSSIAN_KERNELS."""
    import torch

    from gsplat_tpu_torch.models.gaussians import SurfelScene
    from gsplat_tpu_torch.ops import surfels as S
    from gsplat_tpu_torch.ops.binning import bin_gaussians
    from gsplat_tpu_torch.ops.cuda import surfels as SK
    from gsplat_tpu_torch.ops.projection import sh_degree
    from gsplat_tpu_torch.render.pipeline import render_jit
    from gsplat_tpu_torch.train.loop import make_optimizer, make_train_step
    from splatbench import gen, port, roofline_surfels
    from splatbench.reference import render as ref_render
    from splatbench.reference import surfels as ref_surfels

    with open(SURF_CONFIG) as f:
        config = json.load(f)
    with open(SURF_TRAFFIC) as f:
        traffic = json.load(f)
    rc, tc, sc = config["render"], config["train"], config["surfels"]
    cfg = port.render_config(rc)
    fields = gen.make_scene(config, SURF_SEED, dev)
    fields["log_scales"] = fields["log_scales"][:, :2].contiguous()
    scene = SurfelScene(**fields)
    n = scene.num_gaussians
    views = gen.view_matrices(traffic["poses"])
    cams = [port.camera(v, rc["width"], rc["height"], dev)
            for v in views[SURF_VIEW:SURF_VIEW + SURF_STEPS]]
    cam = cams[0]
    flat = tuple(getattr(scene, f.name)
                 for f in dataclasses.fields(SurfelScene))
    cam_t = tuple(getattr(cam, f) for f in SK.CAMERA_FIELDS)
    degree = sh_degree(scene, cfg)
    gen_t = torch.Generator(device=dev).manual_seed(SURF_SEED)

    # K12 and K13 on the whole frame.
    with torch.no_grad():
        k = S.project_surfels(scene, cam, cfg)
        p, plain_fwd_ms = timed_once(
            lambda: S._project_surfels_plain(scene, cam, cfg))
    fwd = compare_surfel_projection(k, p)
    del p
    g = [torch.randn(getattr(k, f).shape, generator=gen_t, device=dev)
         for f in S.SURFEL_OUTPUTS]
    leaves = [t.detach().clone().requires_grad_(True) for t in flat]
    q = S._project_surfels_plain(SurfelScene(*leaves), cam, cfg)
    want, plain_bwd_ms = timed_once(lambda: torch.autograd.grad(
        [getattr(q, f) for f in S.SURFEL_OUTPUTS], leaves, g))
    del q, leaves
    got = SK.surfel_project_bwd_cuda(flat, cam_t, cfg, degree, *g)
    bwd = compare_projection_grads(got, want)
    del got, want
    ms = dict(
        surfel_project_fwd=cuda_ms(lambda: SK.surfel_project_fwd_cuda(
            flat, cam_t, cfg, degree), 20),
        surfel_project_bwd=cuda_ms(lambda: SK.surfel_project_bwd_cuda(
            flat, cam_t, cfg, degree, *g), 20))
    del g
    log(f"[K12/K13 2dgs 1080p] {n} surfels, {int(k.mask.sum())} kept, view "
        f"{SURF_VIEW}: K12 against the plain version {fwd}; K13 against "
        f"autograd of it {bwd}")
    if not (fwd["ok"] and bwd["ok"]):
        raise SystemExit("K12/K13: kernel outside the stated tolerance of "
                         "the plain version")

    # K10 and K11 on the heaviest tile row, and timed on the frame.
    with torch.no_grad():
        binned = bin_gaussians(k, cfg)
        table = S.surfel_table(k)
    del k
    if bool(binned.overflow):
        raise SystemExit("surfels: the view overflowed its stream")
    gid, ranges = binned.sorted_gid, binned.ranges
    outs, aux = SK.surfel_fwd_cuda(table, gid, ranges, cfg)
    ups = [torch.randn(o.shape, generator=gen_t, device=dev) for o in outs]
    row = heaviest_row_index(ranges, cfg)
    ups_row = row_only(ups, row, cfg)
    t0, t1 = row * cfg.tiles_x, (row + 1) * cfg.tiles_x
    s0, s1 = int(ranges[t0]), int(ranges[t1])
    dslot = SK.surfel_bwd_cuda(table, gid, ranges, outs, aux, ups_row, cfg)
    outside = int((dslot[:, :s0] != 0).sum() + (dslot[:, s1:] != 0).sum())
    del dslot
    leaf = table.clone().requires_grad_(True)
    maps = S._RasterizeSurfels.apply(
        leaf, gid, binned.sorted_gidk, binned.gauss_offsets,
        binned.gauss_counts, ranges, cfg)
    (have,) = torch.autograd.grad(maps, leaf, ups_row)
    del maps, leaf
    plain = plain_surfel_row(table, gid, ranges, ups_row, row, cfg)
    res = compare_surfel_row(outs, have, plain)
    log(f"[K10/K11 2dgs 1080p] {int(binned.num_intersections)} "
        f"intersections; tile row {row} (slots {s0}..{s1}) against the plain "
        f"walk of each tile on the card ({plain['fwd_s']} s forward, "
        f"{plain['bwd_s']} s backward): {res}; K11's slot gradients outside "
        f"the row nonzero: {outside}")
    if not (res["ok"] and outside == 0):
        raise SystemExit("K10/K11: kernel outside the stated tolerance of "
                         "the plain walk, or K11 nonzero off the row")
    plain_ms = dict(surfel_fwd=1e3 * plain["fwd_s"],
                    surfel_bwd=1e3 * plain["bwd_s"],
                    surfel_project_fwd=plain_fwd_ms,
                    surfel_project_bwd=plain_bwd_ms)
    del plain, have, ups_row
    ms.update(
        surfel_fwd=cuda_ms(lambda: SK.surfel_fwd_cuda(table, gid, ranges,
                                                      cfg), 20),
        surfel_bwd=cuda_ms(lambda: SK.surfel_bwd_cuda(
            table, gid, ranges, outs, aux, ups, cfg), 20))
    del outs, aux, ups, table, binned, gid, ranges
    torch.cuda.empty_cache()

    # Bounds from the reference's tally of the same view.
    tally = {}
    rcam = ref_render.camera(views[SURF_VIEW], rc["width"], rc["height"],
                             dev)
    ref_surfels.render(fields, rcam, rc, sc, tally=tally)
    torch.cuda.empty_cache()
    work = roofline_surfels.work(tally, rc, n, fields["sh"].shape[1])
    for name, key in (("surfel_fwd", "K10"), ("surfel_bwd", "K11"),
                      ("surfel_project_fwd", "K12"),
                      ("surfel_project_bwd", "K13")):
        ops, n_bytes = work[key]
        bound_ms, bound_by = bound(n_bytes, ops)
        kernels[name].update(
            ms=ms[name], bound_ms=bound_ms, bound_by=bound_by,
            roofline_pct=100.0 * bound_ms / ms[name], library_ms=None,
            plain_ms=plain_ms[name],
            plain_of="the heaviest tile row" if key in ("K10", "K11")
            else "the frame")
        log(f"[{name}] {ms[name]} ms, bound {bound_ms} ms ({bound_by}: "
            f"{ops} ops, {n_bytes} B): {100.0 * bound_ms / ms[name]}% of "
            f"it; plain {plain_ms[name]} ms "
            f"({kernels[name]['plain_of']}); {card}")
    log(f"[surfels] the reference's tally of view {SURF_VIEW}: {tally}")

    # The main path: the cell's captured train step, then a frame.
    targets = gen.make_targets(traffic["targets"], len(views), rc["height"],
                               rc["width"], SURF_SEED, dev,
                               range(SURF_VIEW, SURF_VIEW + SURF_STEPS))
    nodes = {}

    def surfel_path():
        opt = make_optimizer(scene, lr=tc["lr"])
        step = make_train_step(cfg, opt, ssim_weight=tc["ssim_weight"],
                               lambda_dist=sc["lambda_dist"],
                               lambda_normal=sc["lambda_normal"])
        for i in range(SURF_STEPS):
            loss, aux, _ = step(scene, [cams[i]], targets[i:i + 1],
                                tc["active_sh_degree"])
            log(f"[surfels] step {i}: loss {float(loss)}, overflow "
                f"{bool(aux['overflow'])}, grads finite "
                f"{bool(aux['grads_finite'])}")
            if bool(aux["overflow"]) or not bool(aux["grads_finite"]) or \
                    not math.isfinite(float(loss)):
                raise SystemExit(f"surfels: step {i} overflowed or went "
                                 "non-finite")
        (entry,) = step.graphs.entries.values()
        nodes["step"] = entry.nodes
        out = render_jit(scene, cams[0], cfg)
        if bool(out.overflow) or not all(
                bool(torch.isfinite(getattr(out, f)).all())
                for f in ("image", "normals", "depth", "distortion")):
            raise SystemExit("surfels: render_jit's frame failed")

    by_path["surfels"] = counts = drive(
        "surfels", ("surfel_fwd", "surfel_bwd", "surfel_project_fwd",
                    "surfel_project_bwd", "segsum"), surfel_path)
    log(f"[surfels] step graph nodes at capture: {nodes['step']}; {card}")
    expect = dict(surfel_fwd=SURF_STEPS + 1, surfel_project_fwd=SURF_STEPS + 1,
                  surfel_bwd=SURF_STEPS, surfel_project_bwd=SURF_STEPS,
                  segsum=2 * SURF_STEPS, **dict.fromkeys(GAUSSIAN_KERNELS, 0))
    wrong = {k: counts[k] for k, v in expect.items() if counts[k] != v}
    if wrong:
        raise SystemExit(f"surfels: launches {wrong} for {SURF_STEPS} steps "
                         f"and a frame, expected {expect}")
    del scene, fields, targets, flat
    torch.cuda.empty_cache()
    return dict(fwd=fwd, bwd=bwd, row=res, nodes=nodes)


def drive(path, needs, fn):
    """Run one main path with the launch counts set to 0 just before and
    read just after; fail unless each kernel in `needs` was launched."""
    reset_launch_counts()
    fn()
    counts = launch_counts()
    log(f"[{path}] launches {counts}")
    missing = [k for k in needs if counts[k] == 0]
    if missing:
        raise SystemExit(f"{path}: kernels of the path never launched: "
                         f"{missing}")
    return counts


def main() -> int:
    # Drive one card, so that the device count reported is the one used.
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "0")
    os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0]
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    return run(torch.device("cuda", 0))


def run(dev) -> int:
    """Every phase on `dev`, the card."""
    import torch

    from gsplat_tpu_torch import (
        Camera,
        RenderConfig,
        realistic_scene,
        render,
    )
    from gsplat_tpu_torch.convert import scene_from_numpy
    from gsplat_tpu_torch.ops import binning, stream16
    from gsplat_tpu_torch.ops.bf16_pairs import pack_bf16_pairs, unpack_bf16_pairs
    from gsplat_tpu_torch.ops.cuda import _build, cull, raster
    from gsplat_tpu_torch.ops.projection import project_gaussians
    from gsplat_tpu_torch.ops.raster_torch import (
        _image_to_tiles,
        _raster_tiles,
        _raster_tiles_bwd_walk,
        walked_pairs,
    )
    from gsplat_tpu_torch.render.pipeline import SCENE_FIELDS, render_loss_and_grad

    # The plain versions contract in full float32 (no TF32 anywhere).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. Device.
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {card}")
    log(f"[device] torch: {kind}, capability "
        f"{torch.cuda.get_device_capability(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # 2. Build.
    t0 = time.perf_counter()
    _build.build_all()
    log(f"[build] {time.perf_counter() - t0:.3f} s wall, sources "
        f"{sorted(p.name for p in _build.CSRC.glob('*.cu'))}")

    cfg = RenderConfig(**BENCH)
    cfg4 = RenderConfig(**dict(BENCH, **DEFAULT))
    scene = bench_scene(dev)
    cams = views(cfg.width, cfg.height, dev)
    kernels = {name: dict(name=name, route="cuda", source=src, replaces=rep)
               for name, (_, src, rep) in KERNELS.items()}

    # 3. K3 at the bench shape: the compact stage (the base tiers' route)
    # and the mask stage against their plain versions; the route the
    # compact stage replaced (the mask stage, where, row sort, sum) timed
    # beside it; then rows with NaN parameters through every stage.
    with torch.no_grad():
        proj = project_gaussians(scene, cams[0], cfg)
        params = cull.cull_params(proj, cfg)
    kmax, ts = cfg.max_tiles_per_gaussian, cfg.tile_size
    n_rows = params.shape[1]
    mask_k = cull.cull_mask_cuda(params, kmax, ts)
    mask_p, mask_ms_p = timed_once(
        lambda: cull.cull_mask_plain(params, kmax, ts))
    mask_differ = int((mask_k != mask_p).sum())
    ck_k, cnt_k = cull.cull_compact_cuda(params, kmax, ts)
    (ck_p, cnt_p), ms_p = timed_once(
        lambda: cull.cull_compact_plain(params, kmax, ts))
    ck_differ = int((ck_k != ck_p).sum())
    cnt_differ = int((cnt_k != cnt_p).sum())
    log(f"[K3] {n_rows} rows x K {kmax}: {int(cnt_k.sum())} lanes kept; "
        f"compact stage: {ck_differ} entries of compact_k and {cnt_differ} "
        f"counts differ from the plain version; mask stage: {mask_differ} "
        f"lanes differ")
    if ck_differ or cnt_differ or mask_differ:
        raise SystemExit("K3: kernel differs from the plain version")
    ms_k = cuda_ms(lambda: cull.cull_compact_cuda(params, kmax, ts), 50)
    route_ms = cuda_ms(lambda: cull.compact_from_mask(
        cull.cull_mask_cuda(params, kmax, ts)), 50)
    mask_ms = cuda_ms(lambda: cull.cull_mask_cuda(params, kmax, ts), 50)
    bound_ms, bound_by = cull_bound("compact", n_rows, kmax)
    mask_bound, _ = cull_bound("mask", n_rows, kmax)
    kernels["cull"].update(
        max_abs_err=float(max((ck_k - ck_p).abs().max(),
                              (cnt_k - cnt_p).abs().max())),
        ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, route_ms=route_ms, mask_ms=mask_ms,
        mask_plain_ms=mask_ms_p, mask_bound_ms=mask_bound,
    )
    log(f"[K3] compact stage {ms_k} ms, plain {ms_p} ms, bound {bound_ms} ms "
        f"({bound_by}); the route it replaced (mask stage, where, row sort, "
        f"sum) {route_ms} ms; mask stage {mask_ms} ms, plain {mask_ms_p} ms, "
        f"bound {mask_bound} ms")
    del mask_k, mask_p, ck_k, ck_p, cnt_k, cnt_p
    nan_rows = cull_nan_rows(params)
    nan_differ = {}
    for stage, kernel, plain in (
            ("mask", cull.cull_mask_cuda, cull.cull_mask_plain),
            ("compact", cull.cull_compact_cuda, cull.cull_compact_plain),
            ("rank", cull.cull_rank_cuda, cull.cull_rank_plain),
            ("count", lambda *a: cull.cull_count_cuda(
                *a, True, cfg.tiles_x, 0, cfg.num_tiles),
             lambda *a: cull.cull_count_plain(
                 *a, True, cfg.tiles_x, 0, cfg.num_tiles))):
        got, want = kernel(nan_rows, kmax, ts), plain(nan_rows, kmax, ts)
        if stage == "mask":
            got, want = (got,), (want,)
        nan_differ[stage] = [int((g != w).sum()) for g, w in zip(got, want)]
    kept = cull.cull_mask_plain(nan_rows, kmax, ts).view(
        cull.NUM_ROWS, -1).sum(1).tolist()
    log(f"[K3 NaN rows] {nan_rows.shape[1]} rows, one parameter NaN per "
        f"group ({cull.R_GX}..{cull.R_COUNT}); lanes the plain version keeps "
        f"per group {kept}; differing entries per stage and output "
        f"{nan_differ}")
    if any(any(d) for d in nan_differ.values()):
        raise SystemExit("K3 NaN rows: kernel differs from the plain version")
    del nan_rows
    # K3's count and emit stages (the 'packed' binning) on the same rows.
    kernels["cull"].update(packed_bench=check_packed_stages(proj, cfg,
                                                            "bench"))
    # Its tier count and tier emit (the 'tiered' binning) on the bench
    # ladder's rows of the same projection.
    kernels["cull"].update(tier_bench=check_tier_stages(proj, cfg, "bench"))

    # 4. K1 blend at the bench shape on the port's own binned stream: the
    # float32 stream and the packed4 stream of the same binning. The walk
    # lengths price the walk at the granularity of one pixel, a 32-pixel
    # warp, a warp of the kernels' multi-pixel walk (a 32 x `strip_rows`
    # strip of a 32x32 tile: the build's pixels per thread) and a whole tile.
    strip_rows = raster.pixels_per_thread()
    with torch.no_grad():
        binned = binning.bin_gaussians(proj, cfg)
        features = binning.gather_features(proj, binned, cfg)
        slots = stream16.gather_packed(binning.features_f32(proj, cfg4),
                                       binned.sorted_gid, cfg4)
    ranges = binned.ranges
    total = int(binned.num_intersections)
    fwd = {}
    for name, c, stream in (("raster_fwd", cfg, features),
                            ("raster_fwd_packed", cfg4, slots)):
        col_k, tr_k, col_p, tr_p, walk, err, ms_p = check_k1(
            c.stream_format, stream, ranges, c)
        strip = 32 * strip_rows
        walked = {g: walked_pairs(walk, g)
                  for g in (1, 32, strip, c.pixels_per_tile)}
        log(f"[K1 {c.stream_format}] pairs walked per pixel {walked[1]}, "
            f"per 32-pixel warp {walked[32]} ({walked[32] / walked[1]}x), "
            f"per 32x{strip_rows}-strip warp {walked[strip]} "
            f"({walked[strip] / walked[1]}x), per tile "
            f"{walked[c.pixels_per_tile]} "
            f"({walked[c.pixels_per_tile] / walked[1]}x); longest pixel walk "
            f"{int(walk.amax())}, longest segment "
            f"{int((ranges[1:] - ranges[:-1]).amax())}")
        if c.stream_format == "f32":
            skips = warp_skip_counts(stream, ranges, walk, c, strip_rows)
            log(f"[K1 f32] (32x{strip_rows}-strip warp, Gaussian) steps "
                f"walked {skips['steps']}: the power floor skips "
                f"{skips['floor']} ({skips['floor'] / skips['steps']})")
            kernels[name].update(warp_steps=skips)
        ms_k = cuda_ms(lambda: raster.raster_tiles_cuda(stream, ranges, c), 20)
        blend_bytes = (total * stream.shape[0] * 4 + ranges.numel() * 4
                       + (col_k.numel() + tr_k.numel()) * 4)
        blend_ops = walked[1] * BLEND_OPS_PER_PAIR
        bound_ms, bound_by = bound(blend_bytes, blend_ops)
        kernels[name].update(
            max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            walked_pairs={str(g): v for g, v in walked.items()},
        )
        log(f"[K1 {c.stream_format}] kernel {ms_k} ms, plain {ms_p} ms, bound "
            f"{bound_ms} ms ({blend_bytes} B, {blend_ops} ops, {bound_by})")
        fwd[name] = (col_k, tr_k, col_p, tr_p, walked[1])
        del walk

    # 5. K2 blend backward on the same streams: float32 in and out, and
    # packed4 in with bf16 pairs out.
    gen = torch.Generator(device=dev).manual_seed(1)
    g_image = torch.randn((cfg.height, cfg.width, 3), generator=gen, device=dev)
    g_trans = torch.randn((cfg.height, cfg.width), generator=gen, device=dev)
    g_col = _image_to_tiles(g_image, cfg)
    g_tt = _image_to_tiles(g_trans[..., None], cfg)[:, 0]
    bwd = {}
    for name, fname, c, stream in (
            ("raster_bwd", "raster_fwd", cfg, features),
            ("raster_bwd_packed", "raster_fwd_packed", cfg4, slots)):
        *fwd_out, pairs = fwd.pop(fname)
        pack = stream is slots
        d_k, applied, err, ms_p = check_k2(c.stream_format, stream, ranges, c,
                                           fwd_out, g_col, g_tt, pack)
        b_k = ((g_col * fwd_out[0]).sum(1) + g_tt * fwd_out[1]).contiguous()
        ms_k = cuda_ms(lambda: raster.raster_bwd_cuda(
            stream, ranges, g_col, b_k, c, pack_out=pack), 20)
        rbwd_bytes = (total * stream.shape[0] * 4 + d_k.numel() * 4
                      + (g_col.numel() + b_k.numel() + ranges.numel()) * 4)
        rbwd_ops = (pairs * BLEND_BWD_OPS_PER_WALKED
                    + applied * BLEND_BWD_OPS_PER_APPLIED
                    + total * BLEND_BWD_OPS_PER_SLOT)
        bound_ms, bound_by = bound(rbwd_bytes, rbwd_ops)
        kernels[name].update(
            max_abs_err=err, ms=ms_k, plain_ms=ms_p, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, deterministic=True,
        )
        log(f"[K2 {c.stream_format}] kernel {ms_k} ms, plain {ms_p} ms, bound "
            f"{bound_ms} ms ({rbwd_bytes} B, {rbwd_ops} ops, {bound_by})")
        bwd[name] = d_k
        del fwd_out, b_k

    # 6. K4 on K2's float32 gradients and K5 on its bf16 pairs, sorted
    # gid-major as the gather backward sorts them; then the hand-made run
    # layouts.
    kmax_s = binning.kmax_eff(cfg)
    key = torch.where(binned.sorted_gidk >= 0, binned.sorted_gidk, 2**31 - 1)
    s_key, perm = torch.sort(key)
    rows = (s_key >> binning._kbits(kmax_s)).to(torch.int32)
    for name in ("raster_bwd", "raster_bwd_packed"):
        x = bwd.pop(name).index_select(1, perm).contiguous()
        seg = "segsum" if name == "raster_bwd" else "segsum_packed"
        kernels[seg].update(check_segsum("kmax 64", x, rows, kmax_s),
                            library_ms=None)
        del x
    check_segsum_layouts(dev)
    del rows, s_key, perm, key, features, slots, binned, proj, params
    del g_col, g_tt

    # 7. The realistic scene with the jumbo tiers: K3 on the jumbo grid, and
    # K5 and K4 at depth 2048 on K2's pairs of its packed4 stream.
    rcfg = RenderConfig(**dict(BENCH, **DEFAULT, **JUMBO))
    gen = torch.Generator(device=dev).manual_seed(0)
    rscene = realistic_scene(NUM_GAUSSIANS, sh_degree=3, generator=gen,
                             device=dev)
    with torch.no_grad():
        proj = project_gaussians(rscene, cams[0], rcfg)
        rect = proj.rect
        area = (torch.clamp_min(rect[:, 2] - rect[:, 0], 0)
                * torch.clamp_min(rect[:, 3] - rect[:, 1], 0))
        area = torch.where(proj.mask, area, 0)
        ids_r = torch.sort(-area).indices[: rcfg.jumbo_tier_spec[0][1]]
        kj = rcfg.max_tiles_jumbo
        # The walk bound of binning._jumbo_candidates: the raw rect up to
        # kj, 0 for the rows that are not jumbo.
        jbound = torch.where(area > rcfg.max_tiles_per_gaussian,
                             torch.clamp_max(area, kj), 0)
        jparams = cull.cull_params(proj, rcfg, counts=jbound)[
            :, ids_r].contiguous()
    got = cull.cull_rank_cuda(jparams, kj, rcfg.tile_size)
    want, jms_p = timed_once(
        lambda: cull.cull_rank_plain(jparams, kj, rcfg.tile_size))
    differ = [int((g != w).sum()) for g, w in zip(got, want)]
    log(f"[K3 jumbo] {int((area > rcfg.max_tiles_per_gaussian).sum())} "
        f"splats past K {rcfg.max_tiles_per_gaussian} (largest rect "
        f"{int(area.max())} tiles); rank stage on {jparams.shape[1]} rows x "
        f"K {kj}: {int(got[2].sum())} lanes kept; mask, rank, counts: "
        f"{differ} entries differ from the plain version")
    if any(differ):
        raise SystemExit("K3 jumbo: kernel differs from the plain version")
    jms_k = cuda_ms(lambda: cull.cull_rank_cuda(jparams, kj, rcfg.tile_size),
                    20)
    jroute_ms = cuda_ms(lambda: cull.rank_from_mask(
        cull.cull_mask_cuda(jparams, kj, rcfg.tile_size)), 20)
    jbound_ms, jbound_by = cull_bound("rank", jparams.shape[1], kj)
    log(f"[K3 jumbo] rank stage {jms_k} ms, plain {jms_p} ms, bound "
        f"{jbound_ms} ms ({jbound_by}); the route it replaced (mask stage, "
        f"cumsum, sum) {jroute_ms} ms")
    kernels["cull"].update(jumbo_ms=jms_k, jumbo_plain_ms=jms_p,
                           jumbo_bound_ms=jbound_ms,
                           jumbo_bound_by=jbound_by,
                           jumbo_route_ms=jroute_ms)
    # The rank stage at the viewer preset's K_jumbo, 1024 (two rows to a
    # warp in csrc/cull.cu), on the same rows with each walk bounded at
    # 1024: `cli_render`'s own jumbo grid holds no lanes at its 800x800.
    with torch.no_grad():
        jparams = cull.cull_params(proj, rcfg, counts=torch.clamp_max(
            jbound, 1024))[:, ids_r].contiguous()
    got = cull.cull_rank_cuda(jparams, 1024, rcfg.tile_size)
    want = cull.cull_rank_plain(jparams, 1024, rcfg.tile_size)
    differ = [int((g != w).sum()) for g, w in zip(got, want)]
    log(f"[K3 jumbo K 1024] rank stage on {jparams.shape[1]} rows x K 1024: "
        f"{int(got[2].sum())} lanes kept; mask, rank, counts: {differ} "
        "entries differ from the plain version")
    if any(differ) or not int(got[2].sum()):
        raise SystemExit("K3 jumbo K 1024: kernel differs from the plain "
                         "version, or no lane was kept")
    del got, want, jparams, jbound
    # The tier count and tier emit on the bench ladder's rows and the jumbo
    # tiers' rows of the realistic view.
    kernels["cull"].update(tier_jumbo=check_tier_stages(proj, rcfg,
                                                        "realistic jumbo"))

    with torch.no_grad():
        rbinned = binning.bin_gaussians(proj, rcfg)
        rslots = stream16.gather_packed(binning.features_f32(proj, rcfg),
                                        rbinned.sorted_gid, rcfg)
    rtotal = int(rbinned.num_intersections)
    log(f"[realistic] view 0: {rtotal} intersections, overflow "
        f"{bool(rbinned.overflow)}")
    if bool(rbinned.overflow):
        raise SystemExit("realistic: view 0 overflows the bench capacity")
    # K1 and K2 (packed4, bf16 pairs out) on the realistic stream, whose
    # jumbo splats make the longest segments.
    rranges = rbinned.ranges
    col_k, tr_k, col_p, tr_p, walk, err1, ms1_p = check_k1(
        "packed4 realistic", rslots, rranges, rcfg)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_col = _image_to_tiles(torch.randn((cfg.height, cfg.width, 3),
                                        generator=gen, device=dev), rcfg)
    g_tt = torch.randn(tr_k.shape, generator=gen, device=dev)
    d_k, _, err2, ms2_p = check_k2("packed4 realistic", rslots, rranges, rcfg,
                                   (col_k, tr_k, col_p, tr_p), g_col, g_tt,
                                   True)
    b_k = ((g_col * col_k).sum(1) + g_tt * tr_k).contiguous()
    ms1 = cuda_ms(lambda: raster.raster_tiles_cuda(rslots, rranges, rcfg), 20)
    ms2 = cuda_ms(lambda: raster.raster_bwd_cuda(rslots, rranges, g_col, b_k,
                                                 rcfg, pack_out=True), 20)
    log(f"[K1/K2 packed4 realistic] {int(walk.sum())} pairs walked, per "
        f"tile {walked_pairs(walk, rcfg.pixels_per_tile)}; kernel ms K1 {ms1}"
        f" (plain {ms1_p}), K2 {ms2} (plain {ms2_p})")
    kernels["raster_fwd_packed"].update(realistic_ms=ms1,
                                        realistic_max_abs_err=err1)
    kernels["raster_bwd_packed"].update(realistic_ms=ms2,
                                        realistic_max_abs_err=err2)
    del col_p, tr_p, walk, b_k
    kmax_j = binning.kmax_eff(rcfg)
    key = torch.where(rbinned.sorted_gidk >= 0, rbinned.sorted_gidk,
                      2**31 - 1)
    s_key, perm = torch.sort(key)
    rows = (s_key >> binning._kbits(kmax_j)).to(torch.int32)
    xp = d_k.index_select(1, perm).contiguous()
    # K4 on the same gradients unpacked to float32: the run layout of the
    # exact step's realistic stream at depth 2048.
    x = unpack_bf16_pairs(xp, binning.NUM_FEATURES).contiguous()
    for seg, xin in (("segsum_packed", xp), ("segsum", x)):
        r = check_segsum("kmax 2048", xin, rows, kmax_j)
        kernels[seg].update({f"kmax2048_{k}": r[k] for k in (
            "ms", "plain_ms", "bound_ms", "max_abs_err")})
    del x, xp, rows, s_key, perm, key, d_k, g_col, g_tt, col_k, tr_k, rslots
    del rbinned, rranges, proj, area, ids_r

    # 8. Golden: the JAX reference scene through K3 and K1; packed16 K1 and
    # K2 at that shape against their plain versions.
    gdir = os.path.join(HERE, "tests", "golden")
    with np.load(os.path.join(gdir, "scene_42_300.npz")) as d:
        gnp = {k: d[k] for k in d.files}
    gscene = scene_from_numpy(**gnp, device=dev)
    with np.load(os.path.join(gdir, "render_64.npz")) as d:
        golden = d["image"].astype(np.float32)
    gcam = Camera.default(64, 64, device=dev)
    before = launch_counts()
    out = render(gscene, gcam, RenderConfig(**GOLDEN))
    g_db = psnr(out.image.cpu().numpy(), golden)
    now = launch_counts()
    rose = {k: now[k] - before[k] for k in ("cull", "raster_fwd")}
    log(f"[golden] PSNR {g_db} dB against render_64.npz, launches "
        f"cull +{rose['cull']} raster +{rose['raster_fwd']}")
    if not (g_db > 55.0 and rose["cull"] > 0 and rose["raster_fwd"] > 0):
        raise SystemExit("golden: render below 55 dB or not through the kernels")
    c16 = RenderConfig(**GOLDEN, binning="tiered",
                       **dict(DEFAULT, stream_format="packed16"))
    with torch.no_grad():
        gproj = project_gaussians(gscene, gcam, c16)
        gb = binning.bin_gaussians(gproj, c16)
        s16 = stream16.gather_packed(binning.features_f32(gproj, c16),
                                     gb.sorted_gid, c16)
    col_k, tr_k = raster.raster_tiles_cuda(s16, gb.ranges, c16)
    f16 = stream16.unpack_block(s16, c16)
    col_p, tr_p, _ = _raster_tiles(f16, gb.ranges, 0, c16)
    err16 = max(float((col_k - col_p).abs().max()),
                float((tr_k - tr_p).abs().max()))
    gen = torch.Generator(device=dev).manual_seed(4)
    g_col = torch.randn(col_k.shape, generator=gen, device=dev)
    g_tt = torch.randn(tr_k.shape, generator=gen, device=dev)
    d_k = raster.raster_bwd_cuda(
        s16, gb.ranges, g_col, ((g_col * col_k).sum(1) + g_tt * tr_k).contiguous(),
        c16, pack_out=True)
    d_p = _raster_tiles_bwd_walk(f16, gb.ranges, 0, g_col,
                                 ((g_col * col_p).sum(1) + g_tt * tr_p)[..., None],
                                 c16)[0]
    n16 = int(gb.num_intersections)
    u_k = unpack_bf16_pairs(d_k[:, :n16], 9)
    u_p = unpack_bf16_pairs(pack_bf16_pairs(d_p)[:, :n16], 9)
    rel16 = ((u_k - u_p).norm(dim=1) / u_p.norm(dim=1).clamp_min(1e-30)).tolist()
    within16, ulp16 = pair_shares(u_k, u_p)
    log(f"[golden packed16] K1 max abs err {err16}; K2 bf16 pairs: relative L2"
        f" per row {rel16}, within rtol 2e-3 / atol 2e-4 + one bf16 ulp "
        f"{within16} (one bf16 ulp alone {ulp16}), slots past the "
        f"stream exactly 0: {bool((d_k[:, n16:] == 0).all())}")
    if not (err16 <= 1e-4 and max(rel16) <= 1e-3 and within16 >= 0.999
            and bool((d_k[:, n16:] == 0).all())):
        raise SystemExit("golden packed16: K1 or K2 outside the stated "
                         "tolerance of the plain version")
    del s16, f16, d_k, d_p, col_k, tr_k, col_p, tr_p, g_col, g_tt
    check_nan_opacity(gscene, gcam, dev)
    torch.cuda.empty_cache()
    log(f"[phases 1-8] {time.perf_counter() - t_start:.1f} s")

    # 9. Main paths.
    t0 = time.perf_counter()
    tcfg = RenderConfig(**dict(BENCH, **EXACT))
    rexact = RenderConfig(**dict(BENCH, **EXACT, **JUMBO))
    rserve = RenderConfig(**dict(BENCH, **DEFAULT, **JUMBO))
    by_path, times, view0 = {}, {}, {}
    by_path["serve_f32"] = drive(
        "serve f32", ("cull", "raster_fwd"),
        lambda: times.update(serve_f32=serve("serve f32", scene, cams, cfg,
                                             card, view0)))
    by_path["train_exact"] = drive(
        "train exact", ("cull", "raster_fwd", "raster_bwd", "segsum"),
        lambda: times.update(
            train_exact_random=train("train exact random", scene, cams, tcfg,
                                     dev, card),
            train_exact_realistic=train("train exact realistic", rscene, cams,
                                        rexact, dev, card)))
    by_path["serve_packed4"] = drive(
        "serve packed4", ("cull", "raster_fwd_packed"),
        lambda: times.update(
            serve_packed4_random=serve("serve packed4 random", scene, cams,
                                       cfg4, card, view0),
            serve_packed4_realistic=serve("serve packed4 realistic", rscene,
                                          cams, rserve, card, view0)))
    by_path["train_default"] = drive(
        "train default", ("cull", "raster_fwd_packed", "raster_bwd_packed",
                          "segsum_packed"),
        lambda: times.update(
            train_default_random=train("train default random", scene, cams,
                                       cfg4, dev, card),
            train_default_realistic=train("train default realistic", rscene,
                                          cams, rserve, dev, card)))
    log(f"[main] ms per frame / step {times}")
    log(f"[phase 9] {time.perf_counter() - t0:.1f} s")
    del rscene, scene
    torch.cuda.empty_cache()

    # 10. The user surface: `cli train` with densification, checkpoints and
    # a resume; the bench's 8 runs; `cli render` of the trained PLY.
    t0 = time.perf_counter()
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    fit_report, inputs = {}, {}
    by_path["cli_train"] = drive(
        "cli_train", ("cull", "raster_fwd_packed", "raster_bwd_packed",
                      "segsum_packed"),
        lambda: fit_report.update(check_cli_train(
            os.path.join(out_dir, "train"), card, inputs)))
    check_path_inputs("cli_train", inputs, (
        "cull_compact_cuda", "segmented_suffix_sum_packed_cuda"))
    torch.cuda.empty_cache()
    bench_runs = []
    by_path["bench"] = drive(
        "bench", ("cull", "cull_rank", "raster_fwd", "raster_fwd_packed",
                  "raster_bwd", "raster_bwd_packed", "segsum",
                  "segsum_packed"),
        lambda: bench_runs.extend(check_bench(view0, card)))
    torch.cuda.empty_cache()
    rargv = cli_render_argv(os.path.join(out_dir, "train", "trained.ply"),
                            os.path.join(out_dir, "render"))
    os.makedirs(os.path.join(out_dir, "render"), exist_ok=True)

    def cli_render_path():
        # Orbit view 0's cull: the compact stage at the viewer preset's
        # K_max and the rank stage on its jumbo grid.
        with first_inputs(inputs, cull, "cull_compact_cuda"), \
                first_inputs(inputs, cull, "cull_rank_cuda"):
            cli_run(rargv)

    by_path["cli_render"] = drive(
        "cli_render", ("cull", "cull_rank", "raster_fwd_packed"),
        cli_render_path)
    check_path_inputs("cli_render", inputs,
                      ("cull_compact_cuda", "cull_rank_cuda"))
    check_cli_render_pngs(rargv)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[user surface] {time.perf_counter() - t0:.1f} s")

    # 11. The cost probes: each kernel against its plain version at the TPU
    # script's shapes, then their entry point as a main path.
    t0 = time.perf_counter()
    check_probes(kernels, dev)
    torch.cuda.empty_cache()
    from gsplat_tpu_torch import micro_kernel_costs
    by_path["probes"] = drive("probes", PROBES,
                              lambda: micro_kernel_costs.main(["all"]))
    torch.cuda.empty_cache()
    log(f"[probes] {time.perf_counter() - t0:.1f} s")

    # 12. Golden gradients: the card's kernels against the CPU plain path
    # (last, so that its CPU threads do not share the host with the main
    # paths' timing).
    t0 = time.perf_counter()
    target = np.random.default_rng(0).uniform(size=(64, 64, 3)).astype(np.float32)
    for tag, extra in (("exact", dict(EXACT)),
                       ("bench default", dict(DEFAULT, binning="tiered"))):
        gcfg = RenderConfig(**GOLDEN, **extra)
        before = launch_counts()
        results = []
        for d in (dev, torch.device("cpu")):
            loss_d, g_d = render_loss_and_grad(
                scene_from_numpy(**gnp, device=d),
                Camera.default(64, 64, device=d),
                torch.from_numpy(target).to(d), gcfg)
            results.append((float(loss_d), {f: getattr(g_d, f).cpu().numpy()
                                            for f in SCENE_FIELDS}))
        rose = {k: v - before[k] for k, v in launch_counts().items()
                if v > before[k]}
        worst, shares = {}, {}
        for f in SCENE_FIELDS:
            a, b = results[0][1][f], results[1][1][f]
            if tag == "exact":
                worst[f] = float((np.abs(a - b) / (1e-5 + 5e-3 * np.abs(b))).max())
            else:
                worst[f] = float(np.abs(a - b).max()
                                 / (1e-5 + 1e-2 * np.abs(b).max()))
                shares[f] = float(np.mean(np.abs(a - b)
                                          <= 1e-5 + 8e-3 * np.abs(b)))
        log(f"[golden-grad {tag}] loss card {results[0][0]} cpu "
            f"{results[1][0]}; worst |error| / tolerance per field {worst}"
            f"{'; share within 1e-5 + 8e-3 |cpu| ' + str(shares) if shares else ''}"
            f"; launches {rose}")
        needs = (("raster_bwd", "segsum") if tag == "exact" else
                 ("raster_fwd_packed", "raster_bwd_packed", "segsum_packed"))
        if not (max(worst.values()) <= 1.0
                and all(s >= 0.99 for s in shares.values())
                and all(k in rose for k in needs)):
            raise SystemExit(f"golden gradients {tag}: card outside the "
                             "stated tolerance of the CPU path, or not "
                             f"through {needs}")

    log(f"[phase 12] {time.perf_counter() - t0:.1f} s")

    # 13-17. The multi-device paths.
    t0 = time.perf_counter()
    multi = check_multi_device(card, by_path)
    log(f"[phases 13-17] {time.perf_counter() - t0:.1f} s")

    # 18. The ports of the root tools: the capacity report, the training
    # protocol, the sharded smoke and the demo.
    t0 = time.perf_counter()
    check_tools(card, by_path, view0)
    log(f"[phase 18] {time.perf_counter() - t0:.1f} s")

    # 19. The captured paths: render_jit, the captured train step and
    # render_loss_and_grad against their eager bodies, then `cli train` on
    # the eager step against phase 10's run on the captured one.
    t0 = time.perf_counter()
    scene = bench_scene(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    rscene = realistic_scene(NUM_GAUSSIANS, sh_degree=3, generator=gen,
                             device=dev)
    check_render_jit(scene, rscene, cams, card, by_path)
    check_train_jit(scene, rscene, cams, dev, card, by_path)
    check_loss_and_grad_jit(scene, cams, card, by_path)
    del scene, rscene
    torch.cuda.empty_cache()
    # The eager reference of phase 10's cli_train, not a path: its
    # launches are not counted in launches_by_path.
    check_cli_train_eager(os.path.join(out_dir, "train_eager"), fit_report,
                          card)
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"[phase 19] {time.perf_counter() - t0:.1f} s")

    # 20. The multi-device programs as CUDA graphs on NCCL ranks sharing
    # the card, at the capacities phases 13 and 15 measured.
    t0 = time.perf_counter()
    check_multi_device_jit(card, by_path, multi["shard_capacity"],
                           multi["per_dest_capacity"])
    log(f"[phase 20] {time.perf_counter() - t0:.1f} s")

    # 21. BASELINE config 5 at its own size: the proxy of
    # scripts/probe_config5_memory.py, the 6M-Gaussian 4K scene on one
    # device and Gaussian-sharded on NCCL ranks, and 2M Gaussians at
    # 3840x2160 on one device.
    t0 = time.perf_counter()
    check_config5(dev, card, by_path, kernels)
    log(f"[phase 21] {time.perf_counter() - t0:.1f} s")

    # 22. Feature 3DGS's K6 and K7 on a 1080p view of the benchmark's
    # feature cell, and its captured step as a main path.
    t0 = time.perf_counter()
    check_features(dev, card, by_path, kernels)
    log(f"[phase 22] {time.perf_counter() - t0:.1f} s")

    # 23. The projection's K8 and K9 against the plain versions on
    # bicycle's and garden's first views, and their launches on a captured
    # frame and step.
    t0 = time.perf_counter()
    check_projection(dev, card, by_path, kernels)
    log(f"[phase 23] {time.perf_counter() - t0:.1f} s")

    # 24. 2D Gaussian splatting's K10-K13 against the plain versions on
    # the surfel cell's first view, and their launches on a captured step
    # and frame.
    t0 = time.perf_counter()
    check_surfels(dev, card, by_path, kernels)
    log(f"[phase 24] {time.perf_counter() - t0:.1f} s")

    for stage in ("rank", "count", "emit", "tier_count", "tier_emit"):
        kernels["cull"][f"{stage}_launches_by_path"] = {
            p: c[f"cull_{stage}"] for p, c in by_path.items()}
    for name in kernels:
        kernels[name]["launches_by_path"] = {p: c[name]
                                             for p, c in by_path.items()}
        kernels[name]["launches"] = sum(c[name] for c in by_path.values())
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
