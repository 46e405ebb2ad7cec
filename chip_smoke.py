#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and fail
loudly.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs one CUDA device and exits
non-zero, printing no result, without one (or without the package).

Phase 0 builds the fifteen hand-written Hopper kernels (one nvcc per
source, sm_90a) and times an empty kernel launched the same way, as a
replayed CUDA graph: the floor under any launch.  Phase 1 holds the 3D
kernels (HK1-HK4) against their plain PyTorch versions at the 3D path's
128 px shapes (HK1 from the quad table the rounds use and from the plain
cube, at the phase loop's and the global search's shapes and where its
taps clip at the faces of a full-box table; HK3 also with slices in no
order and of weight zero; HK4 at the hemisphere FSC, as spectrum.fsc
launches it from the two spectra and on three stacked fields, and at the
sigma stage's per-image sums with three fields and with one, its
coordinate form held exact against shell_geometry), and HK1 and HK3 at
the shapes of a 256 px box at its global radius, and HK10 (the MKB
insertion option's blob) on HK3's slices, timed beside it; phase 1b the 2D path's
at 160 px (HK5 at the phase loop's, the global-search block's and the
sigma pass's shapes, at r = 5 and 15; HK6 with the 480,000 slices of a
round into 2K = 60 planes at r_u = 31, and a tenth at 12 and 40; HK2, the likelihood
with its products fused in, at the global-search block of all 30
classes at r = 5 and 15 and at the phase loop's; HK4 at the ring FRC and
the sigma shapes); phase 1 also holds HK2 at the 3D global block of 256
rotations x 151 translations, configs/demo_3D.json's grid.  Phase 1c
holds HK7 (in the orbit form its C4 and D2 take) and HK8 at the 160 px
refinement's and classification's shapes against their plain versions,
checks that two calls of each give identical bits and times each alone,
and times HK3's launches of those paths with their bounds (and HK10 on
the CTF round's slices, a defocus factor a slice).  Each
kernel's timing line gives kernel_ms and plain_ms (CUDA events),
library_ms (one PyTorch call computing the same function: F.grid_sample
for HK1 and HK5, torch.bincount for HK4; none exists for HK2, HK3 and
HK6), bound_ms (the larger of its bytes over 3.35 TB/s and its fp32
operations over 67 TFLOP/s, counted from this run's inputs), what bounds
it and the share bound_ms / kernel_ms; a record under 0.15 ms (the
events measure the host's call rate under ~0.05 ms) also
kernel_alone_ms, its launches replayed as a CUDA graph.  Phase 2 writes a 128
px, 256-image synthetic dataset with the port's generator and runs
three rounds of the demo-grid K=1 3D refinement through
``thunder_tpu_torch.cli.thunder.main`` from the phantom low-passed to 40
A.  It checks that the maps and FSC curves are finite, that the output
files exist, that the resolution ends finer than the 40 A start, that
the final map agrees with the phantom (FSC 0.5) to a finer resolution
than the start model does, that every kernel was launched by that run,
and that each global search launched HK2 once a rotation block a
hemisphere (all classes in one launch).  Phase 3 runs the gather
microbenchmark (``thunder_tpu_torch.micro.gather``: G1-G5 on the eight
cases of the repo's Pallas gathers, exact against plain PyTorch; the
plain version is the library call).  Phase 4 runs 2D classification on
``configs/demo_2D.json`` (K = 30, 160 px) for six rounds through the
CLI on 10,000 synthetic images of 30 templates: FRC curves and class
averages finite, the .mrcs and Class_Info files written, ``res_A``
finer than the 60 A start (a gate this data cannot fail: see
phase_slice_2d), class purity at least 5/K, HK5, HK6, HK2 and HK4
launched, and HK2 launched once a rotation block a hemisphere in every
global search.  Phase 5 runs configs/demo.json's refinement (160 px, K =
1, C4, CTF search, core FSC, grading, mLD = 9) through the CLI on 256
images of the sharp C4 phantom whose defocus is 1.03 times what the .thu
carries: leg (a) from the phantom low-passed to 40 A and, the one value
changed, an "Initial Resolution" of 20 A (r_init 12, where the rule that
lets r grow no longer turns on chance: see SIZE_R below), global rounds
until the state machine enters local search, then local and CTF rounds
until it stops or ROUNDS_A rounds have run (r past
r_global, search type 1, res_A finer at the end than at the first local
round, HK7 once a reconstruction); leg (b) resumed from the generator's
blurred poses with "Global Search" off until CTF search has run at least
two rounds (HK8 once a phase, the median defocus factor moved from 1
toward 1.03); if the state machine has not entered CTF search by round
CTF_FORCE_ROUND the search type is set there, and the run says which
happened; phase 5c resumes the same run with the MKB insertion option
(reco_kernel "mkb", through the API: no CLI names it) for ROUNDS_MKB
rounds and the final reconstruction (maps finite, res_A finer at the end
than at the start, the final map's FSC 0.5 against the phantom finer
than the start model's, HK10 launched and HK3 not, HK7 once a
reconstruction, a second run from the seed bit for bit).  Phase 6 runs configs/demo_3D.json's classification (K = 4,
C4) for four rounds on 256 images of two sharp C4 species (HK2 once a
rotation block a hemisphere, HK7 over the 2K grids in one launch, class
purity above 1.5/K).  Phase 7 runs the post-refinement paths through
their CLIs on 1,024 images of the sharp C4 phantom at 160 px (SNR 8):
``tools genmask`` of the phantom; configs/demo.json resumed in local
search for two rounds with that mask and signal subtraction
(Subtract.mrcs and Subtract.thu written and consistent, HK1 launched
once a hemisphere by save_subtract, the power left inside the image mask
within SUBTRACT_ADD of what the noise and the mask's left-out share
predict); ``reconstruct --sym C4`` from the run's last .thu (HK3 and HK7;
FSC 0.5 against the phantom finer than 12 A and within 3 shells of the
run's own final map); ``postprocess`` of the half maps with the mask and
with the auto-mask (78 FSC rows, finer than 10 A, a finite B factor and
sharpened map, HK4's pair and full-space forms); ``project`` of the
phantom at 2,000 random poses, then ``reconstruct --no-ctf`` (correlation
with the phantom above 0.95); the volume tools on the run's maps and the
STAR converter there and back; then HK1, HK3 and HK4 timed at those
paths' new shapes.  Phase 8 runs ranks that share the card over gloo
(each a process of this script, ``--rank``, with a timeout; any rank's
failure fails the script): 8a the CLI with ``--coordinator /
--num-processes / --process-id`` on 1, 2 (hemi 2 x data 1) and 4 (hemi
2 x data 2) ranks, configs/demo.json resumed in local search on phase
7's 1,024 images for two rounds (each rank loads only its rows, rank 0's
files are read back, each round's FSC-0.143 shell within 3 of the one
process's; the backend, the rank-to-device map and each collective's
calls and bytes printed); 8b the slab path (vol_shard_min_mb 0, HK9
into z-slabs, the slab FFTs) of a round's maps from the same data and
injected draws on 4 ranks against one process; 8c the slab path at a
320 px box's padded 640^3 grid (512 poses of the sharp C4 phantom,
r_u 150) on 4 ranks against one process with whole grids (HK3, HK7),
with each rank's time, peak memory and transpose bytes (8b's maps and
8c's HK9 slab against HK3 then HK7 at relative L2 1e-4, 8c's maps as
under Repeats below); and HK9 against its plain twin at 8b's and
8c's shapes.  Phase 9 runs thunder_tpu_torch/micro/run_parity.py's
cases a (configs/demo.json at 32 px: global, local and CTF rounds) and b
(K = 2 at 24 px) through the CLI on files the generator writes on the
CPU, held to thunder_tpu's committed record (tests/goldens/run_parity/):
as many rounds, each with its r and search type and its FSC-0.143 shell
within one.  A local round, a CTF round and a K = 4 round run
under torch.profiler.  The runs split HK4's launches by what called it (the
FSC / FRC, the preprocess spectra, the sigma stage) and the projection
kernels' by global search, phase loop and sigma pass.  Phases 2 and 4 each run one round (3D round 1, 2D round
4) under torch.profiler, without per-stage syncs, and print its device
time, idle share and heaviest kernels, and its launch calls, kernels and
device time by named range of the optimiser (``thunder:round/<stage>``,
``thunder:phase/<step>``).  The last lines are the card's name and power
limit, then three JSON objects: the profiles, the kernels, and ``{"ok":
true, "device": {...}}``.

Repeats.  HK3, HK6, HK9 and HK10 (cell-owned gathers) and HK4 (sums in
a fixed order) are each called twice on the same inputs at every shape
they are held at, and must give identical bits (as HK7 and HK8 in phase
1c); 8a's 2-rank CLI and 8b's 4 ranks run twice and must write the same
bits.  Phase 2's three rounds, phase 4's first four rounds and phase 5b
up to its first CTF round run again from the same seed into another
output directory: every round's record (r, res_A), FSC curve, poses,
classes, defocus factors and maps must be equal bit for bit (2D: and the
class purity).  Phases 2 and 4 then run one round under
``torch.use_deterministic_algorithms(True, warn_only=True)`` and print
the ops PyTorch names.  8c's one-grid path runs three times and must
repeat; the slab path's free-running maps are held to the one-grid
path's within the spread of that path's maps over the balance counts it
stops at, its insertion to HK3 then HK7, and its reconstruction to the
one-grid reconstruction of the same (F, T) at the same count of balance
iterations (SPREAD_FACTOR_8C below); the one-process peak memory is
printed.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

SIZE = 128
N_IMAGES = 256
SNR = 3.0          # bench.py's make_dataset
PIXEL_SIZE = 1.32
ROUNDS = 3
# The run starts from the phantom low-passed to 40 A.  The phantom's
# blobs carry almost no signal past ~15 A at 128 px, so a run started
# from the phantom itself has nothing to improve; from a low-resolution
# start the refinement has to earn every shell past 40 A.
INIT_MODEL_RES_A = 40.0
# main-path shapes of the 128 px demo grid: global-search band r = 22,
# first-round reconstruction band r_u = 36, 128 images per hemisphere
R_GLOBAL, R_U, N_HEMI = 22, 36, 128
# the 2D path (configs/demo_2D.json): 160 px, K = 30, mS(2D) = 100
# rotations, T = 151 global translations, 10,000 images; search band
# r = 5 at the start and 15 at most in global rounds, reconstruction
# band r_u = 31 in the first rounds.  Six rounds: from random classes
# the K = 30 run collapses onto a few classes in round 1 and rebirth
# reseeds the starved ones, so class purity stays near chance for three
# rounds (0.055, 0.123, 0.120 on an H100) and passes 5/K from round 3 on
# (thunder_tpu shows the same collapse and rebirth on the CPU)
SIZE_2D, K_2D, N_2D, ROUNDS_2D = 160, 30, 10000, 6
# the 2D run's first rounds run twice from its seed (the first changed
# class draw comes at round 3): every output of both runs equal
ROUNDS_2D_AGAIN = 4
# the rounds run under torch.profiler: 3D round 1 (past round 0's
# set-up), 2D round 4 (the collapse and rebirth of rounds 1-3 are over)
PROFILE_3D, PROFILE_2D = 1, 4
R_2D, R_GLOBAL_2D, R_U_2D, N_ROT_2D, N_TRANS_2D = 5, 15, 31, 100, 151
INIT_RES_2D = 60.0
# configs/demo.json and configs/demo_3D.json as THUNDER ships them: 160
# px, C4, mS 10000 (2,560 rotations a hemisphere with C4), mLR 125, mLT 9,
# mLD 9; r_init 5, r_global 18, max_r 78.  256 images of the sharp C4
# phantom, their defocus DEFOCUS_FACTOR times the .thu's.  r grows when the
# median translation spread has not shrunk by 2 % for two rounds running
# (Model::updateR).  At the shipped "Initial Resolution" of 60 A (r = 5)
# that median wanders 0.10-0.30 px above its 0.1 px floor from round to
# round (every global search draws one grid for all images), so the first
# step of r is a matter of chance: rounds 10 and 27 at SNR 1.5 in two runs
# on an H100, round 14 at SNR 3, none in 24 rounds at SNR 8
# (thunder_tpu_torch/micro/r_step_probe.py).  From r = 12 on the median is
# the floor and r steps every third round.  Leg (a) therefore changes one shipped value, "Initial
# Resolution" to INIT_RES_A (r_init 12), and runs at SNR_A for at most
# ROUNDS_A rounds (the run ends itself when the state machine stops); leg
# (b) and the classification keep every shipped value and run at SNR_R.
SIZE_R, N_REFINE, DEFOCUS_FACTOR, SNR_A, SNR_R = 160, 256, 1.03, 1.5, 8.0
INIT_RES_A = 20.0
ROUNDS_A, ROUNDS_B, CTF_FORCE_ROUND = 30, 13, 9
LOCAL_START_RES_A = 12.0     # leg (b)'s start model: the phantom low-passed to here
K_3D, ROUNDS_3D, PROFILE_K4 = 4, 4, 2
# HK7's cases (label, group, grids, box): the hemisphere pair of a K = 1
# round at r_u 36, the eight grids of a K = 4 round at the first rounds'
# r_u 31, one grid at the 160 px box's full band
HK7_CASES = (("C4 K=1 pair", "C4", 2, 152), ("D2 K=1 pair", "D2", 2, 152),
             ("C4 K=4, 2K grids", "C4", 8, 132), ("C4 one grid, full band", "C4", 1, 320))
# HK3's launches on these paths, timed with their bounds (label, images,
# r_u, a defocus factor a slice): a class and hemisphere of a K = 4 round
# (128 images a hemisphere over 4 classes, r_u 31: 132^3) and a hemisphere
# of a CTF round (r_u 74: 304^3)
HK3_REFINE = (("K=4, a class and hemisphere", 32, 31, False),
              ("CTF round, a defocus factor a slice", 128, 74, True))
# HK1 with the 2K = 8 tables of a K = 4 round (band, rotations an image,
# lane of the packing): the phase loop at r_global 18 (76^3 tables: 112
# MiB of quads) and at r 22 (92^3: 199 MiB), the sigma pass at r_u 31
# (128^3: 537 MiB)
K4_BANDS = ((18, 125, None), (22, 125, None), (31, 1, 512))
# phase 7, the post-refinement paths: N_POST 160 px images of the sharp C4
# phantom at SNR_POST (defocus factor 1), ROUNDS_POST local rounds of
# configs/demo.json with a provided mask and signal subtraction, then
# thunder_reconstruct, thunder_postprocess, thunder_project at N_PROJ
# random poses, the volume tools and the STAR converter.  The images'
# signal has SNR_POST times the noise's unit std over the box, so inside
# the 80 A image mask (45 % of the box, where the phantom lies) the
# originals carry P ~ 1 + 64 / 0.45 ~ 140 of power a pixel.  Subtraction
# takes the projection of the masked reference away and leaves the noise
# and the projection of what the mask leaves out; the auto-mask keeps the
# phantom's largest connected part only, and the sharp phantom's small
# blobs lie apart from it.  So the run measures f, the share of the
# phantom's projected power that the mask leaves out (the phantom and the
# phantom times (1 - mask) projected by HK1's plain version at random
# poses), and expects the ratio (1 + f (P - 1)) / P; the errors of the
# rank-1 poses and the noise of the reconstructed reference add to it
# (0.0701-0.0712 in five calls against an expectation of 0.0166 after
# two local rounds: PERF.md section 6).  Gate: the expectation plus
# SUBTRACT_ADD, about 0.1: a third above what was measured
N_POST, SNR_POST, ROUNDS_POST, N_PROJ = 1024, 8.0, 2, 2000
SUBTRACT_ADD = 0.08
# 7c holds reconstruct's FSC-0.5 crossing against the phantom within
# CROSSING_SPREAD shells of 7b's final map's.  Both maps come from
# MAP-free gridding at r_u = 78 (recon/reconstructor.py: balance_weights,
# as in thunder_tpu): the balance treats |k| < r_u pf, insertion fills
# |k| < (r_u - 1) pf, and in the ring between, where only trilinear spill
# lands, W grows by orders of magnitude; what F W holds there reaches the
# top shells through the real-space crop, by an amount that depends on
# the poses.  Over five calls on the same data reconstruct's crossing lay
# at shells 67-76, the final map's at 69-73 (PERF.md section 6); on the
# CPU, thunder_tpu's reconstruct crosses where the port's does on the
# same stack and poses, and both move by 3 shells between pose sets blurred
# alike (tests/test_torch_band_edge.py).  So the gate is one path's
# measured spread from call to call; 7c prints T, W and the crossing
# with W = 1 / T near the edge
CROSSING_SPREAD = 9
# phase 8, ranks sharing the one card over gloo.  8a: the CLI on RANKS_8
# ranks (1, hemi 2 x data 1, hemi 2 x data 2) on phase 7's 1,024 images,
# configs/demo.json resumed in local search for ROUNDS_8 rounds; each
# round's FSC-0.143 shell within SHELL_GATE_8 of the one-process run's.
# 8b / 8c: the slab path against one process, relative L2 at most
# SLAB_TOL (C4's mates are lattice permutations, so pose-side HK9 equals
# HK3 then HK7 up to float order; the balance iterates in full space on
# slabs and in half space on one grid).  8c: a 320 px box at r_u 150, its
# padded 640^3 grid, N_8C poses of the sharp C4 phantom
RANKS_8, ROUNDS_8, SHELL_GATE_8, SLAB_TOL = (1, 2, 4), 2, 3, 1e-4
SIZE_8C, R_U_8C, N_8C = 320, 150, 512
# 8c's maps: at 640^3 with 512 poses MAP-free gridding's balance loop
# amplifies rounding in (F, T).  HK3 and HK9 are gathers, so the one-grid
# path repeats bit for bit (checked), but the slab path sums its grids in
# another order than HK3 then HK7.  The balance loop's stop is a threshold
# (max ||C| - 1| under 1e-2, or from MIN_N_ITER_BALANCE on no decrease
# for two iterations), so two paths whose sums round apart stop at other
# counts: one grid ran 10 and 17 iterations (A, B), 14 and 17 with its
# cells scaled by an ulp, the slabs 11 and 11, and B's maps then differed
# by 7.8e-2 (an NVIDIA H100 80GB HBM3 at 700 W).  So the slab path's
# free-running maps are held to the one-grid path's end to end within
# SPREAD_FACTOR_8C times the farthest that path's own map lies from the
# maps at the counts it stops at (from MIN_N_ITER_BALANCE to the largest
# count it took, its own and with its cells scaled by an ulp), measured in
# the same call, and its count may not lie below those counts; the maps
# at every count from 1 are printed (one process on an NVIDIA H100 80GB
# HBM3 at 700 W: A 3.3e-1 at 1 iteration, 8.8e-2 at 14 against its own
# 10; B 1.6e-1 at 1, 9.4e-2 at 10 against its own 17).  And in two parts.  Insertion: HK9's slab against
# HK3 then HK7 within SLAB_TOL (their (F, T) differ by up to 3.7e-6 of
# max |T|, ~30 ulps).  Reconstruction: the slab path's maps against the
# one-grid reconstruction of HK9's own (F, T) over the whole grid run for
# the slabs' count, within SLAB_TOL or SPREAD_FACTOR_8C times that
# reconstruction's change with its 3D transforms composed as the slabs
# compose theirs (separable_fft), measured in the same call
SPREAD_FACTOR_8C = 2
RANK_TIMEOUT_S = 600
PATH_KERNELS_8A = ("project_slices", "likelihood_block", "insert_trilinear", "shell_sums",
                   "symmetrize_ft")
# phase 5c: configs/demo.json resumed in local search as in 5b with the
# MKB insertion option (reco_kernel "mkb", through the API), ROUNDS_MKB
# rounds and the final reconstruction, run twice from its seed
ROUNDS_MKB = 3
# HK10's operations a sample: the value (as HK3's first pass forms it)
# and, for each of the ~4/3 pi a^3 = 28.7 cells of the blob's ball at a =
# 1.9, the distance, the I0 and three multiply-adds
MKB_VALUE_OPS, MKB_TAP_OPS, MKB_BALL = 70, 40, 4.0 / 3.0 * 3.141592653589793 * 1.9 ** 3
# phase 9: whole runs held round by round to thunder_tpu's committed
# records (thunder_tpu_torch/micro/run_parity.py, tests/goldens/run_parity/)
PARITY_CASES = ("a", "b")
# an H100 SXM's published peaks (HBM3 rate, FP32 vector rate), for bounds
HBM_BYTES_S, FP32_FLOP_S = 3.35e12, 67e12
# why the insertion kernels match their twins to float32 rounding only
GATHER_WHY = "each cell sums its slices in another order than the twin's scatter"
# a record whose call takes less is also timed apart from its wrapper
# (under ~0.05 ms CUDA events around a loop of calls give the host's call
# rate, and up to three times that on a slow host)
ALONE_UNDER_MS = 0.15


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def timed(fn, reps: int, warm: int = 2) -> float:
    """Mean milliseconds per call, CUDA events around ``reps`` calls
    after ``warm`` warm-up calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def timed_once(fn) -> tuple:
    """(result, milliseconds) of one call, CUDA events around it."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare(name, shape, got, ref, rel_tol, reason):
    """max |got - ref| against rel_tol * max |ref|; returns the record."""
    import torch

    got = torch.as_tensor(got)
    ref = torch.as_tensor(ref)
    if got.shape != ref.shape:
        fail(f"{name} {shape}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not bool(torch.isfinite(got).all()):
        fail(f"{name} {shape}: non-finite output")
    err = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    rel = err / max(scale, 1e-30)
    say(f"  {name} {shape}: max_abs_err {err:.3e}  rel {rel:.3e}  "
        f"(tolerance rel {rel_tol:g}: {reason})")
    if not rel <= rel_tol:
        fail(f"{name} {shape}: relative error {rel:.3e} > {rel_tol:g}")
    return err


def _bits(x):
    import torch

    x = torch.view_as_real(x) if x.is_complex() else x
    return x.contiguous().view(torch.int32)


def same_bits(name, shape, first, again) -> None:
    """Fail unless two calls' outputs (a tensor or a tuple of them) are
    identical bit for bit."""
    import torch

    pairs = list(zip(first, again)) if isinstance(first, (tuple, list)) else [(first, again)]
    if not all(torch.equal(_bits(a), _bits(b)) for a, b in pairs):
        fail(f"{name} {shape}: two calls on the same inputs differ")
    say(f"  {name} {shape}: two calls give identical bits")


def same_runs(label: str, out_a: str, out_b: str, rounds: int, maps) -> None:
    """Fail unless two runs of the CLI from one seed wrote the same
    rounds 0 .. rounds - 1: each round's record (r, res_A, res_shell),
    FSC / FRC curve, poses, classes and defocus factors (.thu), and the
    maps ``maps(i)`` names, bit for bit."""
    import numpy as np

    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu

    recs = []
    for out in (out_a, out_b):
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs.append([json.loads(line) for line in f][:rounds])
    if len(recs[1]) != rounds or len(recs[0]) != rounds:
        fail(f"{label}: {len(recs[0])} and {len(recs[1])} round records, expected {rounds}")
    differ = []
    for i in range(rounds):
        for key in ("r", "res_A", "res_shell"):
            if recs[0][i].get(key) != recs[1][i].get(key):
                differ.append(f"round {i} {key} {recs[0][i].get(key)} / {recs[1][i].get(key)}")
        a, b = (np.loadtxt(os.path.join(o, f"FSC_Round_{i:03d}.txt")) for o in (out_a, out_b))
        if not np.array_equal(a, b):
            differ.append(f"round {i} FSC")
        ta, tb = (read_thu(os.path.join(o, f"Meta_Round_{i:03d}.thu")) for o in (out_a, out_b))
        for field in ("quat", "trans", "class_id", "defocus_factor"):
            if not np.array_equal(np.asarray(getattr(ta, field)), np.asarray(getattr(tb, field))):
                differ.append(f"round {i} {field}")
        for name in maps(i):
            ma, mb = (read_mrc(os.path.join(o, name))[0] for o in (out_a, out_b))
            if not np.array_equal(ma.view(np.int32), mb.view(np.int32)):
                differ.append(f"round {i} {name}")
    if differ:
        fail(f"{label}: two runs from one seed differ: {differ[:12]}")
    say(f"  {label}: a second run from the same seed wrote rounds 0-{rounds - 1} bit for bit "
        f"(records, FSC curves, poses, classes, defocus factors, {len(maps(0))} map(s) a round)")


def rerun(cfg_path: str, tag: str, rounds: int, dev, before_round=None) -> str:
    """The CLI once more on ``cfg_path``'s data and seed for ``rounds``
    rounds into the output directory ``tag`` beside it (``before_round``
    as in run_cli_counting_global); returns that directory."""
    with open(cfg_path) as f:
        cfg = json.load(f)
    out = os.path.join(os.path.dirname(cfg_path), tag)
    cfg["Basic"]["Path of Output"] = out + "/"
    cfg["Advanced"]["Max Number of Iteration"] = rounds
    path = os.path.join(os.path.dirname(cfg_path), f"{tag}.json")
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)
    t0 = time.time()
    rc, _, _ = run_cli_counting_global([path, "--device", str(dev)], lambda o, i: False,
                                       before_round)
    if rc != 0:
        fail(f"{tag}: thunder main returned {rc}")
    say(f"  {tag}: {rounds} rounds again in {time.time() - t0:.1f} s")
    return out


def determinism_probe(label: str, cfg_path: str, dev) -> list:
    """One round of ``cfg_path``'s run under
    torch.use_deterministic_algorithms(True, warn_only=True): the ops
    PyTorch names as without a deterministic implementation on the card
    (the hand kernels are not PyTorch's to name).  Uninitialised memory
    is not filled, so the run computes what it computes without the
    probe."""
    import warnings

    import torch

    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    named = lambda caught: sorted({" ".join(str(w.message).split())[:240] for w in caught
                                   if "determinis" in str(w.message).lower()})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        if fill is not None:
            det.fill_uninitialized_memory = False
        try:
            rerun(cfg_path, f"probe_{label}", 1, dev)
            ops = named(caught)
            # the control: a weighted bincount on the card has no
            # deterministic implementation, so the probe must name it
            torch.bincount(torch.arange(8, device=dev) % 3, torch.ones(8, device=dev))
            control = len(named(caught)) > len(ops)
        finally:
            torch.use_deterministic_algorithms(False)
            if fill is not None:
                det.fill_uninitialized_memory = fill
    say(f"  {label} determinism probe (one round): {len(ops)} op(s) named"
        + "".join(f"\n    {op}" for op in ops)
        + f"; the control (a weighted bincount) {'named' if control else 'NOT named'}")
    if not control:
        fail(f"{label} determinism probe: PyTorch's warnings do not reach the probe")
    return ops


def low_pass(vol, shell: float, edge: float = 2.0):
    """Raised-cosine low-pass of a real FFT-layout volume: 1 below
    ``shell``, 0 beyond ``shell + edge`` (in Fourier shells)."""
    import numpy as np

    from thunder_tpu_torch.physics.mask import radial_grid

    r = radial_grid(vol.shape[-1], 3)          # |k| in np.fft.fftn's layout
    w =0.5 * (1 + np.cos(np.pi * np.clip((r - shell) / edge, 0, 1)))
    return np.real(np.fft.ifftn(np.fft.fftn(vol) * w)).astype(np.float32)


def agreement_shell(vol, truth) -> int:
    """The last shell before the FSC of ``vol`` against ``truth`` (host
    arrays of one box) first drops below 0.5 (the last of size / 2 - 2
    shells when it never does)."""
    import torch

    from thunder_tpu_torch.ops.fourier import fft3_centered
    from thunder_tpu_torch.physics import spectrum

    a, b = (fft3_centered(torch.as_tensor(v)) for v in (vol, truth))
    curve = spectrum.fsc(a, b, vol.shape[-1] // 2 - 2).numpy()
    return max(spectrum.res_p(curve, 0.5), 1)


def agreement_res(vol, truth) -> float:
    """Resolution (A) at which the FSC of ``vol`` against ``truth`` first
    drops below 0.5."""
    return vol.shape[-1] * PIXEL_SIZE / agreement_shell(vol, truth)


def band_edge_report(f_grid, t_grid, truth) -> None:
    """What MAP-free gridding does at the band's edge of one pair of
    (size pf)^3 grids (F, T): the mean T and W (balance_weights) by
    padded shell from 2 (r_u - 3) to 2 r_u + 1, and the FSC-0.5 crossing
    against ``truth`` of the map made with W = 1 / T (T floored at 1e-6
    of its largest value) in place of the balance."""
    import torch

    from thunder_tpu_torch.recon import reconstructor as rc

    size, pf = truth.shape[-1], f_grid.shape[-1] // truth.shape[-1]
    r_u, big, dev = size // 2 - 2, f_grid.shape[-1], f_grid.device
    k = (torch.arange(big, device=dev) - big // 2).float()
    u = torch.sqrt(k[:, None, None] ** 2 + k[None, :, None] ** 2
                   + k[None, None, :] ** 2).round().long().reshape(-1)
    count = torch.bincount(u, minlength=big).clamp(min=1)
    first, last = 2 * (r_u - 3), 2 * r_u + 1

    def by_shell(x):
        m = (torch.bincount(u, x.reshape(-1).double(), minlength=big) / count).cpu()
        return " ".join(f"{float(v):.3g}" for v in m[first:last + 1])

    w = rc.balance_weights(t_grid, pf, r_u)
    say(f"  7c band edge (insertion fills padded |k| < {(r_u - 1) * pf}, the balance treats "
        f"|k| < {r_u * pf}): mean T by padded shell {first}-{last}: {by_shell(t_grid)}")
    say(f"  7c band edge: mean W by padded shell {first}-{last}: {by_shell(w)}")
    del w
    inside = rc._quad_inside(big, r_u * pf, dev)
    w_t = torch.where(inside, 1.0 / torch.clamp(t_grid, min=1e-6 * float(t_grid.max())),
                      torch.zeros_like(t_grid))
    vol = rc.finalize_reconstruction(f_grid, w_t, size, pf, r_u).cpu().numpy()
    say(f"  7c band edge: the same grids with W = 1 / T cross FSC 0.5 against the phantom "
        f"at shell {agreement_shell(vol, truth)}")


def grid_sample_call(table, rot, i_col, i_row, pf: int, cls):
    """HK1's or HK5's function as ONE F.grid_sample call (bilinear /
    trilinear, align_corners, border), built outside the timed call:
    table (K, n^nd) complex -> real channels; coordinates rot . (pf i_col,
    pf i_row) in index units.  3D: images grouped by class in equal runs
    (N = K); 2D: the K planes become the depth of one 5D volume and each
    image samples its own plane at an integer depth.  Returns (call,
    to_lrp) where to_lrp maps its output to (L, R, P) complex."""
    import torch
    import torch.nn.functional as F

    nd = table.ndim - 1
    n = table.shape[-1]
    n_k, (n_l, n_r) = table.shape[0], rot.shape[:2]
    fx, fy = (i_col * pf).float(), (i_row * pf).float()
    g = torch.stack([rot[..., i, 0:1] * fx + rot[..., i, 1:2] * fy for i in range(nd)], -1)
    g = (g + n // 2) * (2.0 / (n - 1)) - 1                    # (L, R, P, nd)
    if nd == 3:
        order = torch.argsort(cls, stable=True)
        inp = torch.view_as_real(table).movedim(-1, 1).contiguous()     # (K, 2, n, n, n)
        grid = g[order].reshape(n_k, n_l // n_k, n_r, -1, 3).contiguous()
        back = lambda o: torch.empty_like(o.movedim(1, -1).reshape(n_l, n_r, -1, 2)).index_copy_(
            0, order, o.movedim(1, -1).reshape(n_l, n_r, -1, 2))
    else:
        inp = torch.view_as_real(table).movedim(-1, 0)[None].contiguous()  # (1, 2, K, n, n)
        z = (cls.float() * (2.0 / max(n_k - 1, 1)) - 1)[:, None, None, None].expand(g.shape[:-1] + (1,))
        grid = torch.cat([g, z], -1)[None].contiguous()                # (1, L, R, P, 3)
        back = lambda o: o[0].movedim(0, -1)
    call = lambda: F.grid_sample(inp, grid, mode="bilinear", padding_mode="border",
                                 align_corners=True)
    return call, lambda o: torch.view_as_complex(back(o).contiguous())


def bincount_call(values, shell, n_sh: int, weight):
    """HK4's function as ONE torch.bincount call over (field, shell)
    bins; the flat bin index and weights are built outside the call."""
    import torch

    b, c, n = values.shape
    idx = (torch.arange(b * c, device=values.device)[:, None] * (n_sh + 1)
           + torch.clamp(shell.long(), max=n_sh)[None]).reshape(-1)
    w = (values if weight is None else values * weight).reshape(-1).contiguous()
    call = lambda: torch.bincount(idx, w, minlength=b * c * (n_sh + 1))
    return call, lambda o: o.reshape(b, c, n_sh + 1)[..., :n_sh].float()


def bound(n_bytes: float, n_flops: float) -> tuple:
    """(bound_ms, "bytes" or "operations"): the least time the card
    could take, the larger of the bytes over the memory rate and the
    fp32 operations over the fp32 rate."""
    t_b, t_f = n_bytes / HBM_BYTES_S * 1e3, n_flops / FP32_FLOP_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def record(name, shape, err, ms, plain_ms, n_bytes, n_flops, library_ms=None, alone=None,
           **extra):
    """A kernel's record at one shape, with its bound and share, and its
    timing line.  ``alone``: the timed call; when it took under
    ALONE_UNDER_MS, where CUDA events around a loop of calls measure the
    host's call rate, its launches are also replayed as a CUDA graph
    (``alone_ms``, the kernel's own device time)."""
    b_ms, by = bound(n_bytes, n_flops)
    lib = "null" if library_ms is None else f"{library_ms:.4f}"
    alone_ms = None
    if alone is not None and ms < ALONE_UNDER_MS:
        from thunder_tpu_torch.micro.launch_floor import graph_ms

        alone_ms = graph_ms(alone)
    say(f"  {name} [{shape}]: kernel_ms {ms:.4f}  plain_ms {plain_ms:.4f}  library_ms {lib}  "
        f"bound_ms {b_ms:.4f} ({by})  share {b_ms / ms:.4f}"
        + ("" if alone_ms is None else f"  kernel_alone_ms {alone_ms:.4f}"))
    return dict(shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=b_ms, bound_by=by, share=b_ms / ms, alone_ms=alone_ms, **extra)


def lk_operands(dev, gen, n_l: int, n_k: int, n_r: int, n_t: int, r: int, size: int,
                per_image: bool):
    """HK2's inputs at one main-path block: L noisy images' dat_w, sctf2
    and a (sigRcp -1/2 for unit noise power, CTF in [0.3, 1)); pri (K,
    L, R, P) per image or one block per class shared by all images
    (image stride 0); tra (L, T, P) per image or shared; priors per
    image or ones."""
    import torch

    from thunder_tpu_torch.ops.fourier import pack_rings, translate_phases

    rings = pack_rings(size, r, 1, device=dev)
    n_p = rings.i_col.numel()
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    cplx = lambda *s: torch.complex(rnd(*s), rnd(*s))
    s = -0.5 * rings.mask
    dat = cplx(n_l, n_p)
    ctf = 0.3 + 0.7 * torch.rand(n_l, n_p, generator=gen, device=dev)
    dat_w, sctf2 = (s * ctf) * dat, s * ctf * ctf
    a = (s * dat.abs() ** 2).sum(-1)
    if per_image:
        pri = 0.5 * cplx(n_k, n_l, n_r, n_p)
        tra = translate_phases(rings, 3 * rnd(n_l, n_t, 2))
        w_r = torch.rand(n_l, n_r, generator=gen, device=dev)
        w_t = torch.rand(n_l, n_t, generator=gen, device=dev)
    else:
        pri = (0.5 * cplx(n_k, 1, n_r, n_p)).expand(n_k, n_l, n_r, n_p)
        tra = translate_phases(rings, 3 * rnd(n_t, 2))[None].expand(n_l, n_t, n_p)
        w_r = torch.ones(1, 1, device=dev).expand(n_l, n_r)
        w_t = torch.ones(1, 1, device=dev).expand(n_l, n_t)
    return dat_w.to(torch.complex64), sctf2, a, pri, tra, w_r, w_t


def lk_run(fn, ops, blocks: int = 1):
    """``blocks`` consecutive rotation blocks through HK2 (or its plain
    version ``fn``) into fresh accumulators (base, w_c, w_r, w_t)."""
    import torch

    dat_w, sctf2, a, pri, tra, w_r, w_t = ops
    n_k, n_l, n_r = pri.shape[:3]
    dev = a.device
    acc = (torch.full((n_k, n_l), float("-inf"), device=dev), torch.zeros(n_k, n_l, device=dev),
           torch.zeros(n_k, n_l, blocks * n_r, device=dev),
           torch.zeros(n_k, n_l, tra.shape[1], device=dev))
    for b in range(blocks):
        fn(*ops, *acc, col0=b * n_r)
    return acc


def lk_cost(ops) -> tuple:
    """(bytes, fp32 operations) of one HK2 launch: inputs read once
    (shared ones once), accumulators read and written; C's 2P-deep
    product, B, X and the epilogue's exp and sums."""
    dat_w, sctf2, a, pri, tra, w_r, w_t = ops
    n_k, n_l, n_r, n_p = pri.shape
    n_t = tra.shape[1]
    nbytes = lambda x, shared: 4 * x.numel() * (2 if x.is_complex() else 1) // shared
    n_bytes = (nbytes(dat_w, 1) + nbytes(sctf2, 1) + nbytes(a, 1)
               + nbytes(pri, n_l if pri.stride(1) == 0 else 1)
               + nbytes(tra, n_l if tra.stride(0) == 0 else 1)
               + nbytes(w_r, n_l * n_r if w_r.stride(0) == 0 else 1)
               + nbytes(w_t, n_l * n_t if w_t.stride(0) == 0 else 1)
               + 2 * 4 * n_k * n_l * (2 + n_r + n_t))
    n_flops = n_k * n_l * (4 * n_p * n_r * n_t + 4 * n_p * n_r + 6 * n_p * n_t + 8 * n_r * n_t)
    return n_bytes, n_flops


def lk_check(name, ops, blocks: int, timing: bool):
    """HK2 against its plain version (block_terms / local_terms +
    lse_block) on ``ops``; returns the record (timed when ``timing``)."""
    from thunder_tpu_torch.ops import likelihood

    dat_w, _, _, pri, tra, _, _ = ops
    n_k, n_l, n_r, n_p = pri.shape
    shape = f"{name} L={n_l} K={n_k} R={n_r} T={tra.shape[1]} P={n_p}"
    got = lk_run(likelihood.likelihood_block, ops, blocks)
    ref = lk_run(likelihood.likelihood_block_plain, ops, blocks)
    err = max(compare("likelihood_block", f"{shape} {nm}", g, r, 1e-4,
                      "2P-long dot products summed in another order than cuBLAS's; "
                      "exp amplifies it")
              for nm, g, r in zip(("base", "w_c", "w_r", "w_t"), got, ref))
    del got, ref
    if not timing:
        return dict(shape=shape, max_abs_err=err)
    n_bytes, n_flops = lk_cost(ops)
    acc = lk_run(likelihood.likelihood_block, ops)     # the launch alone: given accumulators
    return record("likelihood_block", shape, err,
                  timed(lambda: lk_run(likelihood.likelihood_block, ops), 10),
                  timed(lambda: lk_run(likelihood.likelihood_block_plain, ops), 2, warm=1),
                  n_bytes, n_flops,
                  alone=lambda: likelihood.likelihood_block(*ops, *acc, col0=0))


def hk4_records(dev, gen, size: int, nd: int, n_b: int, n_img: int, r_u: int, label: str):
    """HK4 at one path's shapes.  The FSC / FRC of ``n_b`` reference pairs
    on the centered size^nd grid: "pair", the entry spectrum.fsc takes
    (the three fields formed from the two spectra in the kernel), and
    "grid", the coordinate form on three stacked real fields (the
    preprocess spectra take it with one field); the coordinate form's
    shell index and half-space choice held exact against
    shell_geometry's.  The sigma stage's per-image sums of ``n_img``
    images over the packed rings below r_u (3 fields, "sigma_c3") and
    from r_u to max_r (1 field, "sigma_c1").  Bounds count what each form
    must read: the half space's cells of a centered grid, every packed
    pixel."""
    import torch

    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.physics import spectrum

    n_sh = size // 2 - 2
    n = size ** nd
    half_cells = size ** (nd - 1) * (size - size // 2 + 1)
    why = "float32 sums in another order (fixed: two calls give identical bits)"
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    u, half = spectrum.shell_geometry(size, nd, dev)
    n_all = int(u.max()) + 1
    ones = torch.ones(1, 1, n, device=dev)
    cnt = spectrum.shell_sums_grid(ones, size, nd, n_all)
    if not (torch.equal(cnt, spectrum.shell_sums_plain(ones, u, n_all, half))
            and torch.equal(spectrum.shell_sums_grid(u.float()[None, None], size, nd, n_all),
                            cnt * torch.arange(n_all, device=dev))
            and torch.equal(spectrum.shell_sums_grid(ones, size, nd, n_all, False),
                            spectrum.shell_sums_plain(ones, u, n_all))):
        fail(f"shell_sums {label}: the coordinate form's shells or half space differ from "
             f"shell_geometry's on the {size}^{nd} grid")
    say(f"  shell_sums {label}: coordinate form exact against shell_geometry, {size}^{nd} grid, "
        f"{n_all} shells")
    recs = {}
    vals = rnd(n_b, 3, n) ** 2
    ref = spectrum.shell_sums_plain(vals, u, n_sh, half)
    shape = f"{label} B={n_b} C=3 N={size}^{nd} shells={n_sh}"
    call = lambda: spectrum.shell_sums_grid(vals, size, nd, n_sh)
    got = call()
    same_bits("shell_sums", f"grid form {shape}", got, call())
    err = compare("shell_sums", f"grid form {shape}", got, ref, 1e-4, why)
    lib, lib_out = bincount_call(vals, u, n_sh, half)
    compare("bincount (HK4's library yardstick)", shape, lib_out(lib()), ref, 1e-4,
            "float32 sums in another order")
    lib_ms = timed(lib, 20)
    out_bytes = n_b * 3 * n_sh * 4
    recs["grid"] = record(
        "shell_sums", f"grid form {shape}", err, timed(call, 50),
        timed(lambda: spectrum.shell_sums_grid_plain(vals, size, nd, n_sh), 5),
        n_b * 12 * half_cells + out_bytes, n_b * 6 * half_cells, library_ms=lib_ms, alone=call)
    del vals, lib
    a = torch.complex(rnd(n_b, n), rnd(n_b, n))
    b = a + 0.5 * torch.complex(rnd(n_b, n), rnd(n_b, n))
    call = lambda: spectrum.fsc_sums(a, b, size, nd, n_sh)
    got = call()
    same_bits("shell_sums", f"pair form {shape}", got, call())
    err = compare("shell_sums", f"pair form {shape}", got,
                  spectrum.fsc_sums_plain(a, b, size, nd, n_sh), 1e-4, why)
    # bincount takes no spectra: its time is the one above, on stacked fields
    recs["pair"] = record(
        "shell_sums", f"pair form {shape}", err, timed(call, 50),
        timed(lambda: spectrum.fsc_sums_plain(a, b, size, nd, n_sh), 5),
        n_b * 16 * half_cells + out_bytes, n_b * 12 * half_cells, library_ms=lib_ms, alone=call)
    del a, b
    for key, rings, n_c in (("sigma_c3", pack_rings(size, r_u, 0, lane=512, device=dev), 3),
                            ("sigma_c1", pack_rings(size, n_sh, r_u, lane=512, device=dev), 1)):
        n_p = rings.i_col.numel()
        pv = rnd(n_img, n_c, n_p) ** 2 * rings.mask
        sh = torch.clamp(rings.i_sig, max=n_sh)
        shape = f"{label} sigma B={n_img} C={n_c} P={n_p} shells={n_sh + 1}"
        call = lambda: spectrum.shell_sums(pv, sh, n_sh + 1)
        ref = spectrum.shell_sums_plain(pv, sh, n_sh + 1)
        got = call()
        same_bits("shell_sums", shape, got, call())
        err = compare("shell_sums", shape, got, ref, 1e-4, why)
        lib, lib_out = bincount_call(pv, sh, n_sh + 1, None)
        compare("bincount (HK4's library yardstick)", shape, lib_out(lib()), ref, 1e-4,
                "float32 sums in another order")
        recs[key] = record(
            "shell_sums", shape, err, timed(call, 20),
            timed(lambda: spectrum.shell_sums_plain(pv, sh, n_sh + 1), 5),
            pv.numel() * 4 + n_p * 4 + n_img * n_c * (n_sh + 1) * 4, pv.numel(),
            library_ms=timed(lib, 5), alone=call,
            pieces=spectrum.shell_sums_plan(n_img, n_p))
        del pv, ref, lib
    return recs


def hk4_by_caller(shapes: dict) -> dict:
    """HK4's launches of a run by what called it, from the wrapper's
    count by (form, B, C, N): spectrum.fsc (the hemisphere FSC, the ring
    FRC, the final maps' FSC) takes the pair form, the preprocess
    spectra the coordinate form, the sigma stage the row form with
    three fields, with one, and once an image-less count (B = 1); the
    B-factor fit of postprocess the coordinate form over every cell."""
    out = {"fsc_frc": 0, "preprocess": 0, "sigma_c3": 0, "sigma_c1": 0, "count": 0,
           "b_factor": 0}
    for (form, n_b, n_c, _), k in shapes.items():
        key = ("fsc_frc" if form == "pair" else "preprocess" if form == "grid"
               else "b_factor" if form == "full"
               else "sigma_c3" if n_c == 3 else "count" if n_b == 1 else "sigma_c1")
        out[key] += k
    return out


def phase_kernels(dev):
    """Each 3D kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.ops import insert, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.pipeline.synthetic import phantom
    from thunder_tpu_torch.device import generator

    gen = generator(0, dev)
    rng = np.random.default_rng(0)
    results = {}
    r_glob, r_u, n_l = R_GLOBAL, R_U, N_HEMI
    vol = torch.as_tensor(phantom(SIZE, rng), device=dev)

    # HK1 project_slices: phase loop (2 x 128 images x 125 rotations,
    # per-image) and global search (one 256-rotation block, shared), from
    # the quad table Optimiser.proj_table keeps at this size and from the
    # plain cube
    rings = pack_rings(SIZE, r_glob, 1, device=dev)
    n_p = rings.i_col.numel()
    crop = proj_crop_size(SIZE, 2, r_glob)
    table = projector.prepare_projectee_3d_cropped(
        torch.stack([vol, vol * 0.5]), 2, crop).contiguous()
    if not projector.quad_fits(2, crop):
        fail(f"the {crop}^3 table of the 128 px rounds no longer takes the quad layout")
    quads = projector.quad_taps(table)
    rot_l = rotate3d(random_quat(gen, (2 * n_l, 125), dev))
    cls = torch.arange(2 * n_l, device=dev) // n_l
    tail_l = (rot_l, rings.i_col, rings.i_row, 2, cls)
    why = "same coordinates and tap order; the sums may contract into FMAs"
    ref = projector.project_slices_plain(table, *tail_l)
    out = projector.project_slices(quads, *tail_l)
    shape_l = f"L={2 * n_l} R=125 P={n_p} crop={crop}^3"
    e_l = max(compare("project_slices", f"phases, quad table {shape_l}", out, ref, 1e-5, why),
              compare("project_slices", "phases, plain cube",
                      projector.project_slices(table, *tail_l), ref, 1e-5, why))
    lib, lib_out = grid_sample_call(table, *tail_l)
    compare("grid_sample (HK1's library yardstick)", "phases", lib_out(lib()), out, 1e-4,
            "border clamps the coordinate where HK1 clamps each tap")
    cost_l = (table.numel() * 8 + rot_l.numel() * 4 + 8 * n_p + 4 * 2 * n_l + out.numel() * 8,
              out.numel() * 60)
    del out, ref
    plain_l = timed(lambda: projector.project_slices_plain(table, *tail_l), 5)
    rec_l = record("project_slices", shape_l + " quad table", e_l,
                   timed(lambda: projector.project_slices(quads, *tail_l), 20), plain_l,
                   *cost_l, library_ms=timed(lib, 20))
    rec_cube = record("project_slices", shape_l + " plain cube", e_l,
                      timed(lambda: projector.project_slices(table, *tail_l), 20), plain_l,
                      *cost_l, library_ms=rec_l["library_ms"])
    say(f"  quad_taps of the {crop}^3 x 2 table: "
        f"{timed(lambda: projector.quad_taps(table), 10):.4f} ms (once a table a round)")

    rot_g = rotate3d(random_quat(gen, (1, 256), dev))
    tail_g = (rot_g, rings.i_col, rings.i_row, 2, None)
    ref = projector.project_slices_plain(table[:1], *tail_g)
    e_g = max(compare("project_slices", "global R=256 shared, quad table",
                      projector.project_slices(quads[:1], *tail_g), ref, 1e-5, why),
              compare("project_slices", "global R=256 shared, plain cube",
                      projector.project_slices(table[:1], *tail_g), ref, 1e-5, why))
    lib, _ = grid_sample_call(table[:1], rot_g, rings.i_col, rings.i_row, 2,
                              torch.zeros(1, dtype=torch.long, device=dev))
    # a launch of microseconds: CUDA events around the wrapper measure the
    # host's call rate as much as the kernel
    rec_g = record("project_slices", f"global L=1 R=256 P={n_p} crop={crop}^3 quad table", e_g,
                   timed(lambda: projector.project_slices(quads[:1], *tail_g), 50),
                   timed(lambda: projector.project_slices_plain(table[:1], *tail_g), 5),
                   table[:1].numel() * 8 + rot_g.numel() * 4 + 8 * n_p + ref.numel() * 8,
                   ref.numel() * 60, library_ms=timed(lib, 50),
                   alone=lambda: projector.project_slices(quads[:1], *tail_g))
    del ref, quads

    # taps that clip: the full padded box as the table and the whole
    # image grid as the pixels, whose corners reach 181 cells from the
    # centre of a cube that ends at 127
    k = torch.arange(SIZE, dtype=torch.int32, device=dev) - SIZE // 2
    ky, kx = (g.reshape(-1) for g in torch.meshgrid(k, k, indexing="ij"))
    full = torch.randn(1, 2 * SIZE, 2 * SIZE, 2 * SIZE, dtype=torch.complex64, device=dev)
    tail_c = (rotate3d(random_quat(generator(2, dev), (2, 8), dev)), kx, ky, 2, None)
    ref = projector.project_slices_plain(full, *tail_c)
    e_c = max(compare("project_slices", f"clipped taps, full box {2 * SIZE}^3, plain cube",
                      projector.project_slices(full, *tail_c), ref, 1e-5, why),
              compare("project_slices", "clipped taps, quad table",
                      projector.project_slices(projector.quad_taps(full), *tail_c), ref, 1e-5,
                      why))
    del full, ref

    # op level, off the cells' path: a 256 px box at its global radius
    # (r = 43: two 176^3 cubes, 87 MB, past the L2 cache; the quad table
    # would be 349 MB, so proj_table keeps the plain cube)
    size_b, r_b = 2 * SIZE, 2 * (r_glob - 1) + 1
    rings_b = pack_rings(size_b, r_b, 1, device=dev)
    crop_b = proj_crop_size(size_b, 2, r_b)
    if projector.quad_fits(2, crop_b):
        fail(f"the {crop_b}^3 table of a 256 px box would take the quad layout")
    table_b = torch.randn(2, crop_b, crop_b, crop_b, dtype=torch.complex64, device=dev)
    tail_b = (rot_l, rings_b.i_col, rings_b.i_row, 2, cls)
    out = projector.project_slices(table_b, *tail_b)
    e_b = compare("project_slices", f"{size_b} px: L={2 * n_l} R=125 P={rings_b.i_col.numel()} "
                  f"crop={crop_b}^3", out, projector.project_slices_plain(table_b, *tail_b),
                  1e-5, why)
    lib, _ = grid_sample_call(table_b, *tail_b)
    rec_b = record("project_slices", f"{size_b} px: L={2 * n_l} R=125 P={rings_b.i_col.numel()} "
                   f"crop={crop_b}^3 plain cube", e_b,
                   timed(lambda: projector.project_slices(table_b, *tail_b), 5),
                   timed(lambda: projector.project_slices_plain(table_b, *tail_b), 2, warm=1),
                   table_b.numel() * 8 + rot_l.numel() * 4 + 8 * rings_b.i_col.numel()
                   + 4 * 2 * n_l + out.numel() * 8, out.numel() * 60, library_ms=timed(lib, 5))
    del out, table_b, lib
    results["project_slices"] = dict(rec_l, max_abs_err=max(e_l, e_g, e_c, e_b),
                                     plain_cube=rec_cube, global_shape=rec_g, at_256px=rec_b)

    # HK2 likelihood_block at the 3D main-path blocks: global search (128
    # images x one 256-rotation block x 30 translations, two consecutive
    # blocks, shared) and the phase loop (both halves' 256 images x 125
    # rotations x 9 translations, per image), both at r = 22 (P = 728);
    # and the global block at configs/demo_3D.json's 151 translations,
    # which the CTA takes in three rotation sub-blocks
    results["likelihood_block_3d"] = [
        lk_check("3D global", lk_operands(dev, gen, n_l, 1, 256, 30, r_glob, SIZE, False), 2,
                 True),
        lk_check("3D phase", lk_operands(dev, gen, 2 * n_l, 1, 125, 9, r_glob, SIZE, True), 1,
                 True),
        lk_check("3D global T=151", lk_operands(dev, gen, n_l, 1, 256, 151, r_glob, SIZE, False),
                 1, True)]

    # HK3 insert_trilinear: one hemisphere's compacted slices of a global
    # round (128 images x 48 slots) into the r_u = 36 grid
    big = reco_grid_size(SIZE, r_u) * 2
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, SIZE, SIZE, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_l),
                     np.full(n_l, 2e7), np.full(n_l, 0.1), np.zeros(n_l), device=dev)
    n_s = n_l * 48
    img_idx = torch.arange(n_s, device=dev) // 48
    rot = rotate3d(random_quat(gen, (n_s,), dev))
    trans = 3 * torch.randn(n_s, 2, device=dev)
    w = torch.rand(n_s, device=dev) / 48
    ins = lambda: insert.insert_trilinear(ft, ctf, img_idx, rot, trans, w, r_u, 2,
                                          SIZE, PIXEL_SIZE, big)
    ins_p = lambda: insert.insert_trilinear_plain(
        ft, ctf, img_idx, rot, trans, w, r_u, 2, SIZE, PIXEL_SIZE,
        torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
        torch.zeros((big,) * 3, device=dev))
    (fk, tk), (fp, tp) = ins(), ins_p()
    same_bits("insert_trilinear", f"slices={n_s} r_u={r_u} big={big}", (fk, tk), ins())
    e1 = compare("insert_trilinear", f"F slices={n_s} r_u={r_u} big={big}",
                 torch.view_as_real(fk), torch.view_as_real(fp), 1e-4, GATHER_WHY)
    e2 = compare("insert_trilinear", "T", tk, tp, 1e-4, GATHER_WHY)
    npx = int((insert.dense_window(r_u)[2] > 0).sum())
    rec_3 = record(
        "insert_trilinear", f"slices={n_s} r_u={r_u} big={big}^3", max(e1, e2),
        timed(ins, 5), timed(ins_p, 2),
        n_l * npx * 8 + n_l * 32 + n_s * 64 + big ** 3 * 12, n_s * npx * 110)
    # HK10, the MKB option's insertion, on the same slices
    results["insert_mkb"] = hk10_record(
        dev, (ft, ctf, img_idx, rot, trans, w, r_u, 2, SIZE, PIXEL_SIZE), None, big,
        f"slices={n_s} r_u={r_u} big={big}^3", n_l, rec_3["ms"])
    # a sixth of the slices in no order of image, a third of them of weight
    # zero, accumulated into grids that already hold sums; the window's
    # corner pixels lie beyond the padded-radius cut in every case
    pick = torch.randperm(n_s, device=dev)[:n_s // 6]
    w_z = torch.where(torch.arange(pick.numel(), device=dev) % 3 == 0, 0.0, w[pick])
    if not bool((img_idx[pick][1:] < img_idx[pick][:-1]).any()):
        fail("insert_trilinear: the unsorted case came out sorted")
    some = (ft, ctf, img_idx[pick], rot[pick], trans[pick], w_z, r_u, 2, SIZE, PIXEL_SIZE)
    fk2, tk2 = insert.insert_trilinear(*some, big, fk.clone(), tk.clone())
    same_bits("insert_trilinear", "slices in no order, into given grids", (fk2, tk2),
              insert.insert_trilinear(*some, big, fk.clone(), tk.clone()))
    fp2, tp2 = insert.insert_trilinear_plain(*some, fp, tp)
    e3 = max(compare("insert_trilinear", f"F, {pick.numel()} slices in no order, a third of "
                     "weight zero, into given grids", torch.view_as_real(fk2),
                     torch.view_as_real(fp2), 1e-4, GATHER_WHY),
             compare("insert_trilinear", "T, the same", tk2, tp2, 1e-4, GATHER_WHY))
    del fk, tk, fp, tp, fk2, tk2, fp2, tp2

    # op level, off the cells' path: a 256 px box at its global radius
    # (r = 43, r_u = 85: a 348^3 grid, F and T 506 MB, far past the L2
    # cache)
    size_b = 2 * SIZE
    r_ub = 2 * (r_glob - 1) + 1 + round((size_b // 2 - 2) / 3)
    big_b = reco_grid_size(size_b, r_ub) * 2
    ft_b = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, size_b, size_b, device=dev)),
                              dim=(-2, -1)).to(torch.complex64).contiguous()
    wide = (ft_b, ctf, img_idx, rot, trans, w, r_ub, 2, size_b, PIXEL_SIZE)
    zeros_b = lambda: (torch.zeros((big_b,) * 3, dtype=torch.complex64, device=dev),
                       torch.zeros((big_b,) * 3, device=dev))
    (fk, tk), ((fp, tp), plain_ms) = (insert.insert_trilinear(*wide, big_b),
                                      timed_once(lambda: insert.insert_trilinear_plain(
                                          *wide, *zeros_b())))
    shape_b = f"{size_b} px: slices={n_s} r_u={r_ub} big={big_b}^3"
    same_bits("insert_trilinear", shape_b, (fk, tk), insert.insert_trilinear(*wide, big_b))
    e4 = max(compare("insert_trilinear", f"F {shape_b}", torch.view_as_real(fk),
                     torch.view_as_real(fp), 1e-4, GATHER_WHY),
             compare("insert_trilinear", "T", tk, tp, 1e-4, GATHER_WHY))
    del fk, tk, fp, tp
    npx_b = int((insert.dense_window(r_ub)[2] > 0).sum())
    rec_3b = record("insert_trilinear", shape_b, e4,
                    timed(lambda: insert.insert_trilinear(*wide, big_b), 2, warm=1), plain_ms,
                    n_l * npx_b * 8 + n_l * 32 + n_s * 64 + big_b ** 3 * 12,
                    n_s * npx_b * 110)
    del ft_b, wide
    results["insert_trilinear"] = dict(rec_3, max_abs_err=max(e1, e2, e3, e4), at_256px=rec_3b)

    # HK4 shell_sums: the hemisphere FSC (62 shells of the 128^3 box) and
    # the sigma stage's per-image sums (both halves' 256 images)
    results["shell_sums"] = hk4_records(dev, gen, SIZE, 3, 1, 2 * n_l, r_u, "3D")
    return results


def hk10_record(dev, args, d, big: int, shape: str, n_img: int, hk3_ms: float) -> dict:
    """HK10 (insert_mkb) against its plain twin (1e-5 of max |plain|),
    two calls identical, timed beside HK3's time at the same slices
    (``hk3_ms``), with its bound: the images and the slices read once, F
    and T written once; the value and the blob's ~28.7 taps a sample."""
    import torch

    from thunder_tpu_torch.ops import insert

    call = lambda: insert.insert_mkb(*args, big, d=d)
    fk, tk = call()
    same_bits("insert_mkb", shape, (fk, tk), call())
    (fp, tp), plain_ms = timed_once(lambda: insert.insert_mkb_plain(
        *args, torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
        torch.zeros((big,) * 3, device=dev), d))
    err = max(compare("insert_mkb", f"F {shape}", torch.view_as_real(fk),
                      torch.view_as_real(fp), 1e-5, GATHER_WHY),
              compare("insert_mkb", "T, the same", tk, tp, 1e-5, GATHER_WHY))
    del fk, tk, fp, tp
    n_s, r_u = args[3].shape[0], args[6]
    npx = int((insert.dense_window(r_u, edge=True)[2] > 0).sum())
    rec = record("insert_mkb", shape, err, timed(call, 3), plain_ms,
                 n_img * npx * 8 + n_img * 32 + n_s * 64 + big ** 3 * 12,
                 n_s * npx * (MKB_VALUE_OPS + MKB_BALL * MKB_TAP_OPS), hk3_ms=hk3_ms)
    say(f"  insert_mkb [{shape}]: {rec['ms'] / hk3_ms:.2f} x HK3's {hk3_ms:.4f} ms on the "
        "same slices")
    return rec


def phase_kernels_2d(dev):
    """HK5, HK6, HK2 and HK4 against their plain versions at the 2D
    path's shapes."""
    import numpy as np
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import rotate2d_from_unit
    from thunder_tpu_torch.ops import insert, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics.ctf import ctf_params

    gen = generator(1, dev)
    rng = np.random.default_rng(1)
    results = {}

    def rot2d(shape):
        phi = torch.rand(shape, generator=gen, device=dev) * (2 * np.pi)
        return rotate2d_from_unit(torch.stack([torch.cos(phi), torch.sin(phi)], -1))

    # HK5: the phase loop (both halves' images, 9 rotations each, own
    # class of 2K planes) and one global-search block (all classes, 100
    # shared rotations), at the band every round on the card ran at
    # (r = 5) and at the widest global band (r = 15); timed at both
    recs, recs_g = [], []
    for r in (R_2D, R_GLOBAL_2D):
        rings = pack_rings(SIZE_2D, r, 1, device=dev)
        n_p = rings.i_col.numel()
        crop = proj_crop_size(SIZE_2D, 2, r)
        table = torch.randn(2 * K_2D, crop, crop, dtype=torch.complex64, device=dev)
        cls = torch.randint(0, 2 * K_2D, (N_2D,), generator=gen, device=dev)
        args_l = (table, rot2d((N_2D, 9)), rings.i_col, rings.i_row, 2, cls)
        shape = f"L={N_2D} R=9 r={r} P={n_p} crop={crop}^2"
        out = projector.project_slices_2d(*args_l)
        e1 = compare("project_slices_2d", f"phases {shape}", out,
                     projector.project_slices_2d_plain(*args_l), 1e-5,
                     "same coordinates (no FMA); tap sums may contract")
        args_g = (table[:K_2D], rot2d((1, N_ROT_2D)).expand(K_2D, N_ROT_2D, 2, 2),
                  rings.i_col, rings.i_row, 2, torch.arange(K_2D, device=dev))
        shape_g = f"global K={K_2D} R={N_ROT_2D} shared r={r} P={n_p} crop={crop}^2"
        out_g = projector.project_slices_2d(*args_g)
        e2 = compare("project_slices_2d", shape_g, out_g,
                     projector.project_slices_2d_plain(*args_g), 1e-5, "as above")
        lib, lib_out = grid_sample_call(*args_l)
        compare("grid_sample (HK5's library yardstick)", f"phases r={r}", lib_out(lib()), out,
                1e-4, "border clamps the coordinate where HK5 clamps each tap")
        recs.append(record(
            "project_slices_2d", shape, e1,
            timed(lambda: projector.project_slices_2d(*args_l), 20),
            timed(lambda: projector.project_slices_2d_plain(*args_l), 5),
            table.numel() * 8 + N_2D * 9 * 16 + 8 * n_p + 4 * N_2D + out.numel() * 8,
            out.numel() * 30, library_ms=timed(lib, 20),
            alone=lambda: projector.project_slices_2d(*args_l)))
        lib, _ = grid_sample_call(*args_g)
        recs_g.append(record(
            "project_slices_2d", shape_g, e2,
            timed(lambda: projector.project_slices_2d(*args_g), 50),
            timed(lambda: projector.project_slices_2d_plain(*args_g), 5),
            K_2D * crop * crop * 8 + N_ROT_2D * 16 + 8 * n_p + 4 * K_2D + out_g.numel() * 8,
            out_g.numel() * 30, library_ms=timed(lib, 50),
            alone=lambda: projector.project_slices_2d(*args_g)))
        del out, out_g, lib
    # the sigma / norm stage's pass: every image's best rotation, the
    # packed half disc to r_u (lane 512)
    rings = pack_rings(SIZE_2D, R_U_2D, 0, lane=512, device=dev)
    n_p = rings.i_col.numel()
    crop = proj_crop_size(SIZE_2D, 2, R_U_2D)
    table = torch.randn(2 * K_2D, crop, crop, dtype=torch.complex64, device=dev)
    args_s = (table, rot2d((N_2D, 1)), rings.i_col, rings.i_row, 2,
              torch.randint(0, 2 * K_2D, (N_2D,), generator=gen, device=dev))
    shape_s = f"sigma L={N_2D} R=1 r_u={R_U_2D} P={n_p} crop={crop}^2"
    out = projector.project_slices_2d(*args_s)
    e3 = compare("project_slices_2d", shape_s, out, projector.project_slices_2d_plain(*args_s),
                 1e-5, "as above")
    lib, _ = grid_sample_call(*args_s)
    rec_s = record("project_slices_2d", shape_s, e3,
                   timed(lambda: projector.project_slices_2d(*args_s), 20),
                   timed(lambda: projector.project_slices_2d_plain(*args_s), 5),
                   table.numel() * 8 + N_2D * 16 + 8 * n_p + 4 * N_2D + out.numel() * 8,
                   out.numel() * 30, library_ms=timed(lib, 20),
                   alone=lambda: projector.project_slices_2d(*args_s))
    del out, table, lib, args_s
    results["project_slices_2d"] = dict(
        recs[0], at_r15=recs[1], global_shapes=recs_g, sigma_shape=rec_s,
        max_abs_err=max(r["max_abs_err"] for r in recs + recs_g + [rec_s]))

    # HK6 as Optimiser._insert_2d launches it once a round: both halves'
    # 10,000 images x 48 compacted slots into 2K class planes (image l of
    # half h goes to plane h K + its class) at r_u = 31, the first
    # rounds' band; and a tenth of the slots at r_u = 12 and 40
    n_s = N_2D * 48
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(N_2D, SIZE_2D, SIZE_2D, device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, N_2D)
    ctf = ctf_params(np.full(N_2D, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, N_2D),
                     np.full(N_2D, 2e7), np.full(N_2D, 0.1), np.zeros(N_2D), device=dev)
    img_idx = torch.arange(n_s, device=dev) // 48
    cls_img = (torch.randint(0, K_2D, (N_2D,), generator=gen, device=dev)
               + K_2D * (torch.arange(N_2D, device=dev) // (N_2D // 2)))
    slices = (ft, ctf, img_idx, cls_img[img_idx], rot2d((n_s,)),
              3 * torch.randn(n_s, 2, device=dev), torch.rand(n_s, device=dev) / 48)
    recs = {}
    for r_u, n_r in ((R_U_2D, n_s), (12, n_s // 10), (40, n_s // 10)):
        big = reco_grid_size(SIZE_2D, r_u) * 2
        args = tuple(x[:n_r] for x in slices[2:]) + (r_u, 2, SIZE_2D, PIXEL_SIZE)
        args = slices[:2] + args
        ins = lambda: insert.insert_bilinear_2d(*args, big, 2 * K_2D)
        ins_p = lambda: insert.insert_bilinear_2d_plain(
            *args, torch.zeros((2 * K_2D, big, big), dtype=torch.complex64, device=dev),
            torch.zeros((2 * K_2D, big, big), device=dev))
        # the plain version takes seconds a call: the compared call is
        # its one timed call
        fk, tk = ins()
        shape = f"slices={n_r} planes={2 * K_2D} r_u={r_u} big={big}"
        same_bits("insert_bilinear_2d", shape, (fk, tk), ins())
        (fp, tp), plain_ms = timed_once(ins_p)
        e1 = compare("insert_bilinear_2d", f"F {shape}", torch.view_as_real(fk),
                     torch.view_as_real(fp), 1e-4, GATHER_WHY)
        e2 = compare("insert_bilinear_2d", f"T {shape}", tk, tp, 1e-4, GATHER_WHY)
        del fk, tk, fp, tp
        npx = int(insert.in_disc_pixels(r_u).numel())
        # the images the subset's slices touch: their windows are read
        # and their CTF x data formed once each
        n_img = int(img_idx[:n_r].unique().numel())
        recs[r_u] = record(
            "insert_bilinear_2d", shape + "^2", max(e1, e2), timed(ins, 5 if r_u == R_U_2D else 2),
            plain_ms, n_img * (npx * 8 + 32) + n_r * 32 + 2 * K_2D * big * big * 12,
            n_r * npx * 54 + n_img * npx * 80, images=n_img)
    results["insert_bilinear_2d"] = dict(recs[R_U_2D], max_abs_err=max(
        r["max_abs_err"] for r in recs.values()), other_r_u=[recs[12], recs[40]])
    del ft, slices, args

    # HK2 at the 2D main-path blocks: global search (one half's 5,000
    # images x all 30 classes' shared 100-rotation block x 151
    # translations, at r = 5 and 15; timed at r = 5, the band every round
    # ran at) and the phase loop (both halves' 10,000 images x 9 x 9,
    # per image)
    n_l = N_2D // 2
    results["likelihood_block"] = lk_check(
        "2D global r=5", lk_operands(dev, gen, n_l, K_2D, N_ROT_2D, N_TRANS_2D, R_2D, SIZE_2D,
                                     False), 1, True)
    results["likelihood_block_more"] = [
        lk_check("2D global r=15", lk_operands(dev, gen, n_l, K_2D, N_ROT_2D, N_TRANS_2D,
                                               R_GLOBAL_2D, SIZE_2D, False), 1, False),
        lk_check("2D phase", lk_operands(dev, gen, N_2D, 1, 9, 9, R_2D, SIZE_2D, True), 1,
                 True)]

    # HK4 at the 2D shapes: the ring FRC of compare_refs (K class maps of
    # 160^2, max_r rings) and the sigma stage's per-image sums (both
    # halves' images below and above the r_u band)
    results["shell_sums_2d"] = hk4_records(dev, gen, SIZE_2D, 2, K_2D, N_2D, R_U_2D, "2D")
    return results


def run_cli_counting_global(argv: list, profile_round, before_round=None) -> tuple:
    """The port's CLI on ``argv`` (``profile_round``: a round's number,
    or a function of (optimiser, round number) that picks the first round
    it is true for; ``before_round``: called with the same two at the
    start of every round) with Optimiser.expectation_global
    wrapped to count HK2's launches in each global search, it and
    Optimiser.local_phases wrapped to count the projection kernels'
    launches there, and torch.profiler (CPU activity for the optimiser's
    named ranges, CUDA activity for launches and kernels) around round
    ``profile_round`` alone (run without per-stage syncs): (return code,
    [(launches, 2 x rotation blocks)] per global search, {"wall": s,
    "events": raw profiler events, "project": {"global": n, "phase":
    n}}).  One launch a rotation block a hemisphere covers all K
    classes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from thunder_tpu_torch.cli import thunder
    from thunder_tpu_torch.ops.likelihood import likelihood_block
    from thunder_tpu_torch.ops.projector import project_slices, project_slices_2d
    from thunder_tpu_torch.optimiser import ROT_BLOCK, Optimiser

    expectation_global, run_round = Optimiser.expectation_global, Optimiser.run_round
    local_phases = Optimiser.local_phases
    seen, got = [], {"project": {"global": 0, "phase": 0}}
    projections = lambda: project_slices.launches + project_slices_2d.launches

    def counted(self, rings, quats=None, trans=None):
        before, before_p = likelihood_block.launches, projections()
        g = expectation_global(self, rings, quats, trans)
        got["project"]["global"] += projections() - before_p
        n_rot = g["quats"].shape[1]
        block = min(ROT_BLOCK, n_rot)
        seen.append((likelihood_block.launches - before, 2 * (n_rot // block)))
        return g

    def counted_phases(self, rings):
        before_p = projections()
        phases = local_phases(self, rings)
        got["project"]["phase"] += projections() - before_p
        return phases

    def profiled(self, i_round):
        if before_round is not None:
            before_round(self, i_round)
        wanted = (profile_round(self, i_round) if callable(profile_round)
                  else i_round == profile_round)
        if not wanted or "events" in got:
            return run_round(self, i_round)
        got["round"] = i_round
        timing = os.environ.pop("THUNDER_STAGE_TIMING", None)
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                rec = run_round(self, i_round)
                torch.cuda.synchronize()
                got["wall"] = time.perf_counter() - t0
        finally:
            if timing is not None:
                os.environ["THUNDER_STAGE_TIMING"] = timing
        # the raw events: building FunctionEvents from ~300,000 of them
        # (prof.events()) takes tens of seconds
        got["events"] = prof.profiler.kineto_results.events()
        return rec

    Optimiser.expectation_global, Optimiser.run_round = counted, profiled
    Optimiser.local_phases = counted_phases
    try:
        rc = thunder.main(argv)
    finally:
        Optimiser.expectation_global, Optimiser.run_round = expectation_global, run_round
        Optimiser.local_phases = local_phases
    return rc, seen, got


def check_global_launches(label: str, seen: list) -> None:
    if not seen:
        fail(f"{label}: no global search ran")
    bad = [s for s in seen if s[0] != s[1]]
    say(f"  {label} global search: HK2 launches per search {[s[0] for s in seen]}, "
        f"expected 2 x rotation blocks = {seen[0][1]}")
    if bad:
        fail(f"{label}: global search launched HK2 {bad} times, not once a rotation "
             f"block a hemisphere")


def phase_gather(dev, kernels):
    """The gather microbenchmark, counts read around its run."""
    import torch

    from thunder_tpu_torch.micro import gather as micro

    for k in kernels:
        k.launches = 0
    recs, refs = micro.run(dev, say=lambda m: say("  " + m))
    torch.cuda.synchronize()
    return recs, {k.__name__: k.launches for k in kernels}


def purity(cls, truth, k: int) -> float:
    """Share of images whose class's most common true template is their
    own."""
    import numpy as np

    good = sum(int(np.bincount(truth[cls == c], minlength=k).max())
               for c in range(k) if np.any(cls == c))
    return good / len(cls)


def demo_2d(tmp: str, dev) -> tuple:
    """The 2D dataset (N_2D synthetic 160 px images of K_2D templates)
    and configs/demo_2D.json pointed at it, under ``tmp``; returns
    (config path, each image's template)."""
    import numpy as np

    from thunder_tpu_torch.pipeline.synthetic import write_demo

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    write_demo(tmp, n=N_2D, size=SIZE_2D, snr=SNR, seed=0, device=dev, mode="2D", k=K_2D)
    say(f"  2D dataset {N_2D} x {SIZE_2D} px, {K_2D} templates, written in "
        f"{time.time() - t0:.1f} s")
    with open(os.path.join(here, "configs", "demo_2D.json")) as f:
        cfg = json.load(f)
    # the box and the class count are the config's own (160 px, 30)
    cfg["Basic"].update({
        "Size of Image": SIZE_2D, "Number of Classes": K_2D,
        "Number of Threads Per Process": 1,
        "Initial Model": "",
        ".thu File Storing Paths and CTFs of Images": os.path.join(tmp, "particles.thu"),
        "Path of Particles": tmp + "/",
        "Path of Output": os.path.join(tmp, "output") + "/"})
    cfg["Advanced"]["Max Number of Iteration"] = ROUNDS_2D
    cfg_path = os.path.join(tmp, "demo_2D.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg_path, np.load(os.path.join(tmp, "truth.npy"))


def phase_slice_2d(dev, wrappers):
    """ROUNDS_2D rounds of 2D classification on configs/demo_2D.json
    through the CLI, on 10,000 synthetic 160 px images of 30 templates,
    round PROFILE_2D under the profiler."""
    import numpy as np
    import torch

    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu

    with tempfile.TemporaryDirectory(prefix="chip_smoke_2d_") as tmp:
        cfg_path, truth = demo_2d(tmp, dev)
        os.environ["THUNDER_STAGE_TIMING"] = "1"
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        wrappers["shell_sums"].shapes.clear()
        t0 = time.time()
        rc, seen, got = run_cli_counting_global([cfg_path, "--device", str(dev)], PROFILE_2D)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        hk4_shapes = dict(wrappers["shell_sums"].shapes)
        if rc != 0:
            fail(f"2D: thunder main returned {rc}")
        check_global_launches("2D", seen)

        out = os.path.join(tmp, "output")
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if len(recs) != ROUNDS_2D:
            fail(f"2D: {len(recs)} round records, expected {ROUNDS_2D}")
        need = (["Reference_Final.mrcs"]
                + [f"{p}_Round_{i:03d}{x}" for i in range(ROUNDS_2D)
                   for p, x in (("FSC", ".txt"), ("Meta", ".thu"), ("Class_Info", ".txt"),
                                ("Reference", ".mrcs"))])
        missing = [n for n in need if not os.path.exists(os.path.join(out, n))]
        if missing:
            fail(f"2D: missing outputs {missing}")
        purities = []
        for i, rec in enumerate(recs):
            meta = read_thu(os.path.join(out, f"Meta_Round_{i:03d}.thu"))
            idx = np.array([int(p.split("@")[0]) - 1 for p in meta.particle_path])
            purities.append(purity(np.asarray(meta.class_id), truth[idx], K_2D))
            rec["purity"] = purities[-1]
            say(f"  round {i}: r={rec['r']} phases={rec['n_phases']} res={rec['res_A']:.3f} A  "
                f"purity {purities[-1]:.4f}  {rec['elapsed_s']:.3f} s  "
                f"{N_2D / rec['elapsed_s']:.2f} img/s  reborn={rec.get('reborn_classes', [])}  "
                f"stage_ms={json.dumps(rec.get('stage_ms', 'profiled'))}")
            fsc = np.loadtxt(os.path.join(out, f"FSC_Round_{i:03d}.txt"))
            if fsc.size == 0 or not np.isfinite(fsc).all():
                fail(f"2D round {i}: FRC not finite")
            avgs, _ = read_mrc(os.path.join(out, f"Reference_Round_{i:03d}.mrcs"))
            if avgs.shape != (K_2D, SIZE_2D, SIZE_2D) or not np.isfinite(avgs).all():
                fail(f"2D round {i}: class averages of shape {avgs.shape} or non-finite")
            info = np.loadtxt(os.path.join(out, f"Class_Info_Round_{i:03d}.txt"))
            if info.shape != (K_2D, 3):
                fail(f"2D round {i}: Class_Info has shape {info.shape}")
        final, _ = read_mrc(os.path.join(out, "Reference_Final.mrcs"))
        if final.shape != (K_2D, SIZE_2D, SIZE_2D) or not np.isfinite(final).all():
            fail("2D: final class averages bad shape or non-finite")
        say(f"  2D main path wall {wall:.1f} s, launches {launches}")
        say(f"  shell_sums launches by (form, B, C, N): {hk4_shapes}")
        prof = profile_summary(got, PROFILE_2D, "2D")
        prof["shell_sums_launches"] = hk4_by_caller(hk4_shapes)
        res = [r["res_A"] for r in recs]
        # On this data the gate cannot fail: res_A reads the band edge
        # (7.04 A) from round 0, in thunder_tpu as in the port.  The
        # FSC-pass maps are cut from the padded reconstruction box in real
        # space, and the low frequencies both halves share carry past the
        # cut, so the cut's edge lifts the FRC above 0.143 at every ring
        # (the FRC of F.W on the padded grid is at noise level there).
        # Purity is the quality gate of this phase.
        if not res[-1] < INIT_RES_2D:
            fail(f"2D: resolution {res} did not improve on the {INIT_RES_2D} A start")
        if not purities[-1] >= 5 / K_2D:
            fail(f"2D: class purity {purities[-1]:.4f} below 5/K = {5 / K_2D:.4f}")
        zero = [n for n, c in launches.items() if c <= 0]
        if zero:
            fail(f"2D: kernels never launched by the 2D path: {zero}")
        again = rerun(cfg_path, "output_again", ROUNDS_2D_AGAIN, dev)
        same_runs("2D", out, again, ROUNDS_2D_AGAIN, lambda i: [f"Reference_Round_{i:03d}.mrcs"])
        for i in range(ROUNDS_2D_AGAIN):
            meta = read_thu(os.path.join(again, f"Meta_Round_{i:03d}.thu"))
            idx = np.array([int(p.split("@")[0]) - 1 for p in meta.particle_path])
            if purity(np.asarray(meta.class_id), truth[idx], K_2D) != purities[i]:
                fail(f"2D round {i}: purity differs between two runs from one seed")
        say(f"  2D: class purity of rounds 0-{ROUNDS_2D_AGAIN - 1} equal in both runs: "
            f"{[round(p, 4) for p in purities[:ROUNDS_2D_AGAIN]]}")
        prof["determinism_probe"] = determinism_probe("2D", cfg_path, dev)
    return launches, recs, prof


def demo_3d(tmp: str, dev) -> tuple:
    """The 3D dataset (N_IMAGES synthetic 128 px images of the phantom),
    the start model (the phantom low-passed to 40 A) and the demo-grid
    config, under ``tmp``; returns (config path, phantom, start model)."""
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    t0 = time.time()
    cfg_path = write_demo(tmp, n=N_IMAGES, size=SIZE, snr=SNR, seed=0, device=dev)
    say(f"  3D dataset {N_IMAGES} x {SIZE} px written in {time.time() - t0:.1f} s")
    truth, _ = read_mrc(os.path.join(tmp, "init_model.mrc"))
    start = low_pass(truth, SIZE * PIXEL_SIZE / INIT_MODEL_RES_A)
    write_mrc(os.path.join(tmp, "init_model.mrc"), start, PIXEL_SIZE)
    with open(cfg_path) as f:
        cfg = json.load(f)
    basic, adv, prof = cfg["Basic"], cfg["Advanced"], cfg["Professional"]
    basic.update({"Estimated Translation (Pixel)": 3,
                  "Initial Resolution (Angstrom)": 12.0,
                  "Perform Global Search Under (Angstrom)": 8.0,
                  "Radius of Mask on Images (Angstrom)": SIZE * PIXEL_SIZE / 2 * 0.9})
    adv.update({"Max Number of Iteration": ROUNDS, "Padding Factor": 2,
                "Number of Sampling Points for Scanning in Global Search (3D)": 10000,
                "Number of Sampling Points of Rotation in Local Search (3D)": 125,
                "Number of Sampling Points of Translation in Local Search": 9,
                "Number of Sampling Points Used in Reconstruction": 100})
    prof["Translation Search Factor"] = 0.1
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg_path, truth, start


def profile_summary(got: dict, target, label: str) -> dict:
    """Device time (the sum of the CUDA kernel events), idle share (1 -
    device time / the round's wall time under the profiler), kernel and
    launch counts, and the heaviest kernels of the profiled round; then
    the same by the optimiser's named ranges (``thunder:round/<stage>``
    and, inside the phase loop, ``thunder:phase/<step>``): a launch call
    belongs to the innermost range open on the host when it was made, a
    kernel to the range of the call that launched it (matched by the
    profiler's correlation id)."""
    import bisect

    from torch.autograd import DeviceType

    if "events" not in got:
        fail(f"profile {label}: no round was profiled (wanted: {target})")
    target = got["round"]
    levels = {"phase/": [], "round/": []}    # (start, end, name), innermost level first
    calls, device = [], []
    for e in got["events"]:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith("thunder:"):    # the profiler's device-side copy of a range
                continue
            device.append((name, e.duration_ns() / 1e6, e.correlation_id(), e.start_ns()))
        elif name.startswith("thunder:"):
            levels.get(name[8:14], levels["round/"]).append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), name[8:]))
        elif name.startswith("cuda") and e.correlation_id() > 0:
            calls.append((e.correlation_id(), e.start_ns(), "LaunchKernel" in name))
    if not device:
        fail(f"profile {label}: no CUDA kernel events in the profiled round")
    if not levels["round/"]:
        fail(f"profile {label}: the optimiser's named ranges are not in the profile")
    for level in levels.values():
        level.sort()
    starts = {k: [r[0] for r in level] for k, level in levels.items()}

    def range_at(t: int) -> str:
        for k, level in levels.items():
            i = bisect.bisect_right(starts[k], t) - 1
            if i >= 0 and t < level[i][1]:
                return level[i][2]
        return "outside the ranges"

    by_range, call_range = {}, {}
    cell = lambda r: by_range.setdefault(r, dict(launch_calls=0, kernels=0, device_ms=0.0,
                                                 gemm_ms=0.0, gemm_kernels=0, top={}))
    for corr, t, is_launch in calls:
        call_range[corr] = r = range_at(t)
        cell(r)["launch_calls"] += int(is_launch)
    by_name, unmatched = {}, 0
    for name, ms, corr, t in device:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + ms, n + 1)
        unmatched += corr not in call_range
        c = cell(call_range.get(corr) or range_at(t))
        c["kernels"] += 1
        c["device_ms"] += ms
        if "gemm" in name.lower():
            c["gemm_ms"] += ms
            c["gemm_kernels"] += 1
        tot, n = c["top"].get(name, (0.0, 0))
        c["top"][name] = (tot + ms, n + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    launches = sum(c["launch_calls"] for c in by_range.values())
    rec = dict(path=label, round=target, wall_s=got["wall"], device_ms=device_ms,
               idle_share=1 - device_ms / 1e3 / got["wall"],
               kernels=sum(n for _, n in by_name.values()), launch_calls=launches)
    say(f"  profile {label} round {target}: wall {rec['wall_s']:.4f} s, device "
        f"{device_ms:.3f} ms in {rec['kernels']} kernels, idle share "
        f"{rec['idle_share']:.4f}, {launches} launch calls")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"    {ms:10.3f} ms x{n:<6d} {name[:90]}")
    say(f"  profile {label} round {target} by range (launch calls, kernels, device ms, of "
        f"which GEMM kernels and ms; heaviest kernel); {unmatched} kernels matched by time:")
    order = sorted(by_range, key=lambda r: -by_range[r]["launch_calls"])
    for r in order:
        c = by_range[r]
        top = max(c.pop("top").items(), key=lambda kv: kv[1][0], default=("-", (0.0, 0)))
        say(f"    {r:<26s} {c['launch_calls']:7d} {c['kernels']:7d} {c['device_ms']:10.3f}  "
            f"gemm x{c['gemm_kernels']:<6d} {c['gemm_ms']:8.3f}  "
            f"{top[1][0]:8.3f} ms x{top[1][1]:<6d} {top[0][:60]}")
    rec["by_range"] = {r: by_range[r] for r in order}
    rec["project_launches"] = got["project"]
    return rec


def phase_slice(dev, wrappers):
    """Three demo-grid rounds through the CLI on a synthetic dataset,
    round PROFILE_3D under the profiler."""
    import numpy as np
    import torch

    from thunder_tpu_torch.io.mrc import read_mrc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        cfg_path, truth, start = demo_3d(tmp, dev)
        os.environ["THUNDER_STAGE_TIMING"] = "1"
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        wrappers["shell_sums"].shapes.clear()
        t0 = time.time()
        rc, seen, got = run_cli_counting_global([cfg_path, "--device", str(dev)], PROFILE_3D)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: w.launches for name, w in wrappers.items()}
        hk4_shapes = dict(wrappers["shell_sums"].shapes)
        if rc != 0:
            fail(f"thunder main returned {rc}")
        check_global_launches("3D", seen)

        out = os.path.join(tmp, "output")
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        if len(recs) != ROUNDS:
            fail(f"{len(recs)} round records, expected {ROUNDS}")
        for rec in recs:
            say(f"  round {rec['round']}: r={rec['r']} phases={rec['n_phases']} "
                f"res={rec['res_A']:.3f} A  {rec['elapsed_s']:.3f} s  "
                f"{N_IMAGES / rec['elapsed_s']:.2f} img/s  "
                f"stage_ms={json.dumps(rec.get('stage_ms', 'profiled'))}")
        say(f"  main path wall {wall:.1f} s, launches {launches}")
        say(f"  shell_sums launches by (form, B, C, N): {hk4_shapes}")
        prof = profile_summary(got, PROFILE_3D, "3D")
        prof["shell_sums_launches"] = hk4_by_caller(hk4_shapes)
        need = (["Reference_000_Final.mrc", "Reference_000_A_Final.mrc",
                 "Reference_000_B_Final.mrc"]
                + [f"{p}_Round_{i:03d}{s}" for i in range(ROUNDS)
                   for p, s in (("FSC", ".txt"), ("Meta", ".thu"), ("Class_Info", ".txt"),
                                ("Reference_000_A", ".mrc"), ("Reference_000_B", ".mrc"))])
        missing = [n for n in need if not os.path.exists(os.path.join(out, n))]
        if missing:
            fail(f"missing outputs {missing}")
        for i in range(ROUNDS):
            fsc = np.loadtxt(os.path.join(out, f"FSC_Round_{i:03d}.txt"))
            if fsc.size == 0 or not np.isfinite(fsc).all():
                fail(f"round {i}: FSC not finite")
            for tag in "AB":
                m, _ = read_mrc(os.path.join(out, f"Reference_000_{tag}_Round_{i:03d}.mrc"))
                if m.shape != (SIZE,) * 3 or not np.isfinite(m).all():
                    fail(f"round {i}: map {tag} bad shape or non-finite")
        res = [r["res_A"] for r in recs]
        if not res[-1] < INIT_MODEL_RES_A:
            fail(f"resolution {res} did not improve on the {INIT_MODEL_RES_A} A start")
        final, _ = read_mrc(os.path.join(out, "Reference_000_Final.mrc"))
        start_a, final_a = (agreement_res(m, truth) for m in (start, final))
        say(f"  FSC-0.5 against the phantom: start model {start_a:.2f} A, "
            f"final map {final_a:.2f} A (required: final finer than start)")
        if not final_a < start_a:
            fail(f"final map agrees with the phantom to {final_a:.2f} A, "
                 f"no finer than the start model's {start_a:.2f} A")
        zero = [n for n, c in launches.items() if c <= 0]
        if zero:
            fail(f"kernels never launched by the main path: {zero}")
        again = rerun(cfg_path, "output_again", ROUNDS, dev)
        same_runs("3D", out, again, ROUNDS,
                  lambda i: [f"Reference_000_{h}_Round_{i:03d}.mrc" for h in "AB"])
        prof["determinism_probe"] = determinism_probe("3D", cfg_path, dev)
    return launches, recs, prof


def sym_grid_sample_call(f, t, mats):
    """HK7's function as F.grid_sample calls, one a mate: (re, im, T) as
    the channels of a 5D input, the rotated cell coordinates built
    outside the timed calls (border padding clamps the coordinate where
    HK7 clamps each tap: they agree inside the band)."""
    import torch
    import torch.nn.functional as F

    big = f.shape[-1]
    g = f.reshape(-1, big, big, big)
    inp = torch.cat([torch.view_as_real(g).movedim(-1, 1),
                     t.reshape(-1, 1, big, big, big)], 1).contiguous()
    k = torch.arange(big, dtype=torch.float32, device=f.device) - big // 2
    kz, ky, kx = torch.meshgrid(k, k, k, indexing="ij")
    pos = torch.stack([kx, ky, kz], -1)
    grids = [((pos @ m.T + big // 2) * (2.0 / (big - 1)) - 1)[None].expand(
        inp.shape[0], -1, -1, -1, -1).contiguous() for m in mats[1:]]
    return lambda: [F.grid_sample(inp, gr, mode="bilinear", padding_mode="border",
                                  align_corners=True) for gr in grids]


def hk8_operands(dev, gen, n_l: int, n_d: int, n_r: int, n_t: int, r: int, size: int):
    """HK8's inputs at one phase of CTF search: L noisy images' dat_s and
    s_pack (sigRcp near -1/2), astigmatic CTFs of 0.8 to 2 um, defocus
    factors scattered by 0.01 around 1, per-image projections,
    translations of a pixel and priors."""
    import numpy as np
    import torch

    from thunder_tpu_torch.ops.fourier import pack_rings, translate_phases
    from thunder_tpu_torch.ops.likelihood import ctf_terms
    from thunder_tpu_torch.physics.ctf import ctf_params

    rings = pack_rings(size, r, 1, device=dev)
    n_p = rings.i_col.numel()
    rnd = lambda *s: torch.randn(s, generator=gen, device=dev)
    cplx = lambda *s: torch.complex(rnd(*s), rnd(*s))
    rand = lambda *s: torch.rand(s, generator=gen, device=dev)
    s_pack = -0.5 * rings.mask * (0.5 + rand(n_l, n_p))
    dat = cplx(n_l, n_p)
    rng = np.random.default_rng(8)
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * rng.uniform(0.9, 1.1, n_l),
                     rng.uniform(0, 3, n_l), np.full(n_l, 2e7), np.full(n_l, 0.1),
                     np.zeros(n_l), device=dev)
    # projections scaled so that dvp spreads over a few units, as on the path
    pri = (0.3 / n_p ** 0.5) * cplx(n_l, n_r, n_p) + 0.05 * dat[:, None, :]
    return ((s_pack * dat).to(torch.complex64), s_pack,
            ctf_terms(ctf, rings.i_col, rings.i_row, size, PIXEL_SIZE), 1 + 0.01 * rnd(n_l, n_d),
            pri.to(torch.complex64), translate_phases(rings, rnd(n_l, n_t, 2)),
            (s_pack * dat.abs() ** 2).sum(-1), rand(n_l, n_r), rand(n_l, n_t), rand(n_l, n_d))


def phase_kernels_refine(dev):
    """HK7 and HK8 against their plain versions at the shapes of the 160
    px refinement and classification, HK3 with a defocus factor a slice,
    and HK1 from the quad table and from the plain cube with the eight
    tables of a K = 4 round."""
    import numpy as np
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.micro.launch_floor import graph_ms
    from thunder_tpu_torch.ops import insert, likelihood, projector
    from thunder_tpu_torch.ops.fourier import pack_rings
    from thunder_tpu_torch.optimiser import proj_crop_size, reco_grid_size
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.recon import reconstructor

    gen = generator(3, dev)
    results = {}
    why = "same coordinates, weights and tap order; the sums may contract into FMAs"

    recs = []
    for label, sym, n_g, big in HK7_CASES:
        f = torch.complex(torch.randn(n_g, big, big, big, generator=gen, device=dev),
                          torch.randn(n_g, big, big, big, generator=gen, device=dev))
        t = torch.rand(n_g, big, big, big, generator=gen, device=dev)
        mats = Symmetry(sym, dev).matrices
        form = reconstructor.symmetrize_form(mats)
        rad = float(big // 2 - 6)
        shape = f"{label}: {sym} G={n_g} big={big}^3 band {rad:.0f}, {form} form"
        call = lambda: reconstructor.symmetrize_ft(f, t, mats, rad, form)
        got = call()
        again = call()
        if not (torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])):
            fail(f"symmetrize_ft {shape}: two calls on the same inputs differ")
        del again
        (ref, plain_ms) = timed_once(lambda: reconstructor.symmetrize_ft_plain(f, t, mats, rad))
        err = max(compare("symmetrize_ft", f"F {shape}", torch.view_as_real(got[0]),
                          torch.view_as_real(ref[0]), 1e-5, why),
                  compare("symmetrize_ft", "T", got[1], ref[1], 1e-5, why))
        lib = sym_grid_sample_call(f, t, mats)
        inside = ((torch.arange(big, device=dev) - big // 2) ** 2)
        inside = (inside[:, None, None] + inside[None, :, None] + inside[None, None, :]) < rad ** 2
        lib_sum = sum(lib())
        lib_f = torch.complex(lib_sum[:, 0], lib_sum[:, 1]) * inside + f
        compare("grid_sample (HK7's library yardstick)", shape, torch.view_as_real(lib_f),
                torch.view_as_real(ref[0]), 1e-4, "trilinear weights from normalised coordinates")
        del ref, got, lib_sum, lib_f
        n_in = int(inside.sum())
        rec = record(
            "symmetrize_ft", shape, err, timed(call, 10 if big < 300 else 3), plain_ms,
            2 * n_g * big ** 3 * 12 + mats.numel() * 4,
            n_g * n_in * (mats.shape[0] - 1) * 75, library_ms=timed(lambda: lib(), 3, warm=1),
            grids=n_g, mates=int(mats.shape[0] - 1), form=form)
        rec["alone_ms"] = graph_ms(call, calls=10 if big < 300 else 3)
        say(f"  symmetrize_ft [{shape}]: kernel_alone_ms {rec['alone_ms']:.4f}  "
            f"share of that {rec['bound_ms'] / rec['alone_ms']:.4f}")
        recs.append(rec)
        del f, t, lib
    results["symmetrize_ft"] = dict(recs[0], other_shapes=recs[1:],
                                    max_abs_err=max(r["max_abs_err"] for r in recs))

    # HK8 at a CTF phase of both halves (256 images), at r = 22's P = 728
    # and at the box's widest band (max_r 78); the plain version's einsums
    # run 32 images at a time at the wide band (its (L, D, R, P)
    # intermediates would take tens of GB)
    recs = []
    for r, chunk in ((R_GLOBAL, 256), (SIZE_R // 2 - 2, 32)):
        ops = hk8_operands(dev, gen, N_REFINE, 9, 125, 9, r, SIZE_R)
        n_l, n_p = ops[4].shape[0], ops[4].shape[2]
        shape = f"L={n_l} D=9 R=125 T=9 P={n_p} (r={r})"
        call = lambda: likelihood.likelihood_local_ctf(*ops)

        def plain():
            outs = []
            for lo in range(0, n_l, chunk):
                sl = slice(lo, lo + chunk)
                part = [o[sl] if torch.is_tensor(o) else o for o in ops]
                part[2] = ops[2].images(lambda a: a[sl])
                outs.append(likelihood.likelihood_local_ctf_plain(*part))
            return [torch.cat(x) for x in zip(*outs)]

        got = call()
        again = call()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"likelihood_local_ctf {shape}: two calls on the same inputs differ")
        del again
        ref, plain_ms = timed_once(plain)
        # dvp = (a + B) + C is rounded to float32 at |a| ~ 0.75 P, where one
        # ulp in the exponent moves exp by that much: four ulps of |a|, and
        # no less than the 1e-4 of the other kernels
        tol = max(1e-4, 4 * 1.1920929e-07 * float(ops[6].abs().max()))
        err = max(compare("likelihood_local_ctf", f"{shape} {nm}", g, rr, tol,
                          "P-long sums in another order and CTFs formed in the kernel; "
                          "exp amplifies one float32 ulp of a + B + C, |a| ~ 0.75 P")
                  for nm, g, rr in zip(("u_r", "u_t", "u_d"), got, ref))
        spread = float((ref[0].amax(1) / ref[0].mean(1)).median())
        say(f"  likelihood_local_ctf {shape}: median max/mean of u_r {spread:.2f} "
            "(the block is neither flat nor one spike)")
        del got, ref
        n_bytes = (sum(4 * o.numel() * (2 if o.is_complex() else 1)
                       for o in ops if torch.is_tensor(o))
                   + n_l * 32 + n_p * 8 + n_l * (9 + 125 + 9) * 4)
        # what the function needs, not what an einsum over (d, r, t, p)
        # spends: Re(x conj(pri)) does not depend on d, so a (r, t, pixel)
        # costs 2 multiply-adds for it and D more over the defocus axis;
        # then B (|pri|^2 once a (r, pixel), s ctf^2 once a (d, pixel), one
        # multiply-add a (d, r, pixel)), x = dat conj(tra), the CTFs
        # (~30 operations a (d, pixel)) and the epilogue
        n_d, n_r, n_t = 9, 125, 9
        n_flops = n_l * (n_r * n_t * n_p * (4 + 2 * n_d) + n_d * n_r * n_p * 2 + n_r * n_p * 4
                         + n_d * n_p * 2 + n_t * n_p * 6 + n_d * n_p * 30
                         + 12 * n_d * n_r * n_t)
        # the kernel's own time (a replayed CUDA graph) is read whatever
        # the call took: on a slow host CUDA events read the host
        rec = record("likelihood_local_ctf", shape, err, timed(call, 10), plain_ms,
                     n_bytes, n_flops, plan=likelihood.likelihood_ctf_plan(n_d, n_r, n_t))
        rec["alone_ms"] = graph_ms(call)
        say(f"  likelihood_local_ctf [{shape}]: kernel_alone_ms {rec['alone_ms']:.4f}  "
            f"share of that {rec['bound_ms'] / rec['alone_ms']:.4f}")
        recs.append(rec)
        del ops
    results["likelihood_local_ctf"] = dict(recs[0], widest_band=recs[1],
                                           max_abs_err=max(r["max_abs_err"] for r in recs))

    # HK3 with a defocus factor a slice (CTF rounds' use_d): 1,024 slices
    # into the 152^3 grid
    n_l, n_s, r_u = 64, 1024, R_U
    big = reco_grid_size(SIZE_R, r_u) * 2
    rng = np.random.default_rng(4)
    ft = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_l, SIZE_R, SIZE_R, generator=gen,
                                                       device=dev)),
                            dim=(-2, -1)).to(torch.complex64).contiguous()
    defocus = rng.uniform(8000, 20000, n_l)
    ctf = ctf_params(np.full(n_l, 300e3), defocus, defocus * 1.05, rng.uniform(0, 3, n_l),
                     np.full(n_l, 2e7), np.full(n_l, 0.1), np.zeros(n_l), device=dev)
    some = (ft, ctf, torch.arange(n_s, device=dev) % n_l, rotate3d(random_quat(gen, (n_s,), dev)),
            3 * torch.randn(n_s, 2, generator=gen, device=dev),
            torch.rand(n_s, generator=gen, device=dev), r_u, 2, SIZE_R, PIXEL_SIZE)
    d = 1 + 0.03 * torch.randn(n_s, generator=gen, device=dev)
    fk, tk = insert.insert_trilinear(*some, big, d=d)
    same_bits("insert_trilinear", f"a defocus factor a slice, slices={n_s} big={big}", (fk, tk),
              insert.insert_trilinear(*some, big, d=d))
    fp, tp = insert.insert_trilinear_plain(
        *some, torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
        torch.zeros((big,) * 3, device=dev), d)
    results["insert_trilinear_d"] = max(
        compare("insert_trilinear", f"F, a defocus factor a slice, slices={n_s} big={big}",
                torch.view_as_real(fk), torch.view_as_real(fp), 1e-4, GATHER_WHY),
        compare("insert_trilinear", "T, the same", tk, tp, 1e-4, GATHER_WHY))
    del fk, tk, fp, tp, ft
    hk3 = []
    for label, n_i, r_u3, use_d in HK3_REFINE:
        big3 = reco_grid_size(SIZE_R, r_u3) * 2
        ft3 = torch.fft.fftshift(torch.fft.fft2(torch.randn(n_i, SIZE_R, SIZE_R, generator=gen,
                                                            device=dev)),
                                 dim=(-2, -1)).to(torch.complex64).contiguous()
        defocus = rng.uniform(8000, 20000, n_i)
        n_s3 = n_i * 48
        args3 = (ft3, ctf_params(np.full(n_i, 300e3), defocus, defocus * 1.05,
                                 rng.uniform(0, 3, n_i), np.full(n_i, 2e7), np.full(n_i, 0.1),
                                 np.zeros(n_i), device=dev),
                 torch.arange(n_s3, device=dev) // 48, rotate3d(random_quat(gen, (n_s3,), dev)),
                 3 * torch.randn(n_s3, 2, generator=gen, device=dev),
                 torch.rand(n_s3, generator=gen, device=dev) / 48, r_u3, 2, SIZE_R, PIXEL_SIZE)
        d3 = 1 + 0.03 * torch.randn(n_s3, generator=gen, device=dev) if use_d else None
        call3 = lambda: insert.insert_trilinear(*args3, big3, d=d3)
        fk, tk = call3()
        shape3 = f"{label}: slices={n_s3} r_u={r_u3} big={big3}^3"
        same_bits("insert_trilinear", shape3, (fk, tk), call3())
        (fp, tp), plain_ms = timed_once(lambda: insert.insert_trilinear_plain(
            *args3, torch.zeros((big3,) * 3, dtype=torch.complex64, device=dev),
            torch.zeros((big3,) * 3, device=dev), d3))
        err3 = max(compare("insert_trilinear", f"F {shape3}", torch.view_as_real(fk),
                           torch.view_as_real(fp), 1e-4, GATHER_WHY),
                   compare("insert_trilinear", "T, the same", tk, tp, 1e-4, GATHER_WHY))
        del fk, tk, fp, tp
        npx3 = int((insert.dense_window(r_u3)[2] > 0).sum())
        hk3.append(record("insert_trilinear", shape3, err3, timed(call3, 3), plain_ms,
                          n_i * npx3 * 8 + n_i * 32 + n_s3 * 64 + big3 ** 3 * 12,
                          n_s3 * npx3 * 110))
        if use_d:
            # HK10 on the CTF round's slices, a defocus factor a slice
            results["insert_mkb_ctf"] = hk10_record(dev, args3, d3, big3, shape3, n_i,
                                                    hk3[-1]["ms"])
        del ft3, args3
    results["insert_trilinear_refine"] = hk3

    # HK1 with the 2K = 8 tables of a K = 4 round: quad table against plain
    # cube
    quad_k4 = []
    for r, n_rot, lane in K4_BANDS:
        rings = (pack_rings(SIZE_R, r, 1, device=dev) if lane is None
                 else pack_rings(SIZE_R, r, 0, lane=lane, device=dev))
        crop = proj_crop_size(SIZE_R, 2, r)
        table = torch.randn(2 * K_3D, crop, crop, crop, dtype=torch.complex64, device=dev)
        quads = projector.quad_taps(table)
        tail = (rotate3d(random_quat(gen, (N_REFINE, n_rot), dev)), rings.i_col, rings.i_row, 2,
                torch.randint(0, 2 * K_3D, (N_REFINE,), generator=gen, device=dev))
        compare("project_slices", f"K=4: 8 tables of {crop}^3, quad table against plain cube",
                projector.project_slices(quads, *tail), projector.project_slices(table, *tail),
                1e-5, why)
        ms_q = timed(lambda: projector.project_slices(quads, *tail), 10)
        ms_c = timed(lambda: projector.project_slices(table, *tail), 10)
        mib = quads.numel() * 4 / 2 ** 20
        say(f"  project_slices K=4 r={r} R={n_rot} P={rings.i_col.numel()} crop={crop}^3: "
            f"quad table ({mib:.0f} MiB) {ms_q:.4f} ms, plain cube {ms_c:.4f} ms, "
            f"quad_fits says {projector.quad_fits(2 * K_3D, crop)}")
        quad_k4.append(dict(r=r, rotations=n_rot, crop=crop, quad_mib=mib, quad_ms=ms_q,
                            cube_ms=ms_c, quad_fits=projector.quad_fits(2 * K_3D, crop)))
        del table, quads
    results["project_slices_k4"] = quad_k4
    return results


def demo_160(tmp: str, dev, config_name: str, k: int, rounds: int, start_res_a: float,
             local_resume: bool = False, defocus_factor: float = 1.0,
             snr: float = SNR_R, init_res_a: float | None = None,
             n: int = N_REFINE) -> tuple:
    """A 160 px dataset of ``n`` images of ``k`` sharp C4 species under
    ``tmp``, and configs/<config_name> pointed at it with every other
    value as shipped: the start model is the mean phantom low-passed to
    ``start_res_a``; ``local_resume`` turns "Global Search" off and reads
    the generator's blurred poses; ``init_res_a`` replaces "Initial
    Resolution".  Returns (config path, phantom)."""
    from thunder_tpu_torch.io.mrc import read_mrc, write_mrc
    from thunder_tpu_torch.pipeline.synthetic import write_demo

    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.time()
    write_demo(tmp, n=n, size=SIZE_R, snr=snr, seed=0, device=dev, k=k, kind="sharp",
               sym="C4", defocus_factor=defocus_factor)
    say(f"  dataset {n} x {SIZE_R} px at SNR {snr}, {k} sharp C4 species, defocus x "
        f"{defocus_factor}, written in {time.time() - t0:.1f} s")
    truth, _ = read_mrc(os.path.join(tmp, "init_model.mrc"))
    write_mrc(os.path.join(tmp, "start_model.mrc"),
              low_pass(truth, SIZE_R * PIXEL_SIZE / start_res_a), PIXEL_SIZE)
    with open(os.path.join(here, "configs", config_name)) as f:
        cfg = json.load(f)
    cfg["Basic"].update({
        "Initial Model": os.path.join(tmp, "start_model.mrc"),
        ".thu File Storing Paths and CTFs of Images":
            os.path.join(tmp, "particles_local.thu" if local_resume else "particles.thu"),
        "Path of Particles": tmp + "/",
        "Path of Output": os.path.join(tmp, "output") + "/"})
    if local_resume:
        cfg["Basic"]["Global Search"] = False
    if init_res_a is not None:
        cfg["Basic"]["Initial Resolution (Angstrom)"] = init_res_a
    cfg["Advanced"]["Max Number of Iteration"] = rounds
    cfg_path = os.path.join(tmp, config_name)
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)
    return cfg_path, truth


def run_160(label: str, dev, wrappers: dict, cfg_path: str, profile_round,
            before_round=None) -> tuple:
    """One run of the CLI with every wrapper's count set to 0 just before
    and read just after: (launches, round records, output directory's
    path, global searches seen, profile summary)."""
    import torch

    os.environ["THUNDER_STAGE_TIMING"] = "1"
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    rc, seen, got = run_cli_counting_global([cfg_path, "--device", str(dev)], profile_round,
                                            before_round)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    if rc != 0:
        fail(f"{label}: thunder main returned {rc}")
    out = os.path.join(os.path.dirname(cfg_path), "output")
    with open(os.path.join(out, "round_metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    for rec in recs:
        say(f"  {label} round {rec['round']}: r={rec['r']} search {rec['search_type']}->"
            f"{rec['search_type_after']} phases={rec['n_phases']} res={rec['res_A']:.3f} A  "
            f"t_vari={[round(v, 4) for v in rec['t_vari']]}  {rec['elapsed_s']:.3f} s  {N_REFINE / rec['elapsed_s']:.2f} img/s  "
            f"stage_ms={json.dumps(rec.get('stage_ms', 'profiled'))}")
    say(f"  {label} wall {wall:.1f} s, launches {launches}")
    return launches, recs, out, seen, profile_summary(got, "a round", label)


def check_maps(label: str, out: str, rounds: int, k: int) -> None:
    import numpy as np

    from thunder_tpu_torch.io.mrc import read_mrc

    need = [f"Reference_{t:03d}{x}_Final.mrc" for t in range(k) for x in ("", "_A", "_B")]
    need += [f"{p}_Round_{i:03d}{x}" for i in range(rounds)
             for p, x in [("FSC", ".txt"), ("Meta", ".thu"), ("Class_Info", ".txt")]
             + [(f"Reference_{t:03d}_{h}", ".mrc") for t in range(k) for h in "AB"]]
    missing = [n for n in need if not os.path.exists(os.path.join(out, n))]
    if missing:
        fail(f"{label}: missing outputs {missing}")
    for i in range(rounds):
        fsc = np.loadtxt(os.path.join(out, f"FSC_Round_{i:03d}.txt"))
        if fsc.size == 0 or not np.isfinite(fsc).all():
            fail(f"{label} round {i}: FSC not finite")
    for t in range(k):
        m, _ = read_mrc(os.path.join(out, f"Reference_{t:03d}_Final.mrc"))
        if m.shape != (SIZE_R,) * 3 or not np.isfinite(m).all():
            fail(f"{label}: final map {t} bad shape or non-finite")


def phase_refine_a(dev, wrappers):
    """configs/demo.json's refinement from a 40 A start model and r_init
    12: global rounds until the state machine enters local search, then local rounds, the
    first of them under the profiler.  Returns (launches, profile)."""
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.model import SEARCH_TYPE_CTF, SEARCH_TYPE_LOCAL

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refine_a_") as tmp:
        cfg_path, truth = demo_160(tmp, dev, "demo.json", 1, ROUNDS_A, INIT_MODEL_RES_A,
                                   defocus_factor=DEFOCUS_FACTOR, snr=SNR_A,
                                   init_res_a=INIT_RES_A)
        launches["refine_a"], recs, out, seen, prof = run_160(
            "5a", dev, wrappers, cfg_path,
            lambda opt, i: opt.model.search_type == SEARCH_TYPE_LOCAL)
        check_global_launches("5a", seen)
        check_maps("5a", out, len(recs), 1)
        r_global = ThunderConfig.from_json(cfg_path).r_global
        local = [r for r in recs if r["search_type"] == SEARCH_TYPE_LOCAL]
        say(f"  5a: r_global {r_global}; local search from round "
            f"{local[0]['round'] if local else None}; r by round {[r['r'] for r in recs]}")
        if not local:
            fail(f"5a: the state machine never entered local search in {len(recs)} rounds")
        if not max(r["r"] for r in recs) > r_global:
            fail(f"5a: r never grew past r_global {r_global}")
        if not recs[-1]["res_A"] < local[0]["res_A"]:
            fail(f"5a: res_A {recs[-1]['res_A']:.3f} at the end is no finer than "
                 f"{local[0]['res_A']:.3f} at the first local round")
        if launches["refine_a"]["symmetrize_ft"] != len(recs) + 1:
            fail(f"5a: HK7 launched {launches['refine_a']['symmetrize_ft']} times in "
                 f"{len(recs)} rounds and the final reconstruction")
        if launches["refine_a"]["likelihood_local_ctf"] and not any(
                r["search_type"] == SEARCH_TYPE_CTF for r in recs):
            fail("5a: HK8 launched outside CTF search")
    return launches["refine_a"], prof


def phase_refine_b(dev, wrappers):
    """The same refinement resumed in local search from the generator's
    blurred poses, until CTF search has run at least two rounds, the
    first of them under the profiler.  Returns (launches, profile)."""
    import numpy as np

    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.model import SEARCH_TYPE_CTF, SEARCH_TYPE_LOCAL

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refine_b_") as tmp:
        cfg_path, truth = demo_160(tmp, dev, "demo.json", 1, ROUNDS_B, LOCAL_START_RES_A,
                                   local_resume=True, defocus_factor=DEFOCUS_FACTOR)
        forced = []

        def force_ctf(opt, i):
            if i == CTF_FORCE_ROUND and opt.model.search_type == SEARCH_TYPE_LOCAL:
                opt.model.search_type = SEARCH_TYPE_CTF
                opt.model._reset_after_transition()
                forced.append(i)

        launches["refine_b"], recs, out, seen, prof = run_160(
            "5b", dev, wrappers, cfg_path,
            lambda opt, i: opt.model.search_type == SEARCH_TYPE_CTF, force_ctf)
        check_maps("5b", out, len(recs), 1)
        if seen or recs[0]["search_type"] != SEARCH_TYPE_LOCAL:
            fail("5b: the resumed run did not start in local search")
        ctf_rounds = [r for r in recs if r["search_type"] == SEARCH_TYPE_CTF]
        say(f"  5b: CTF search from round {ctf_rounds[0]['round'] if ctf_rounds else None} "
            + (f"(search type set at round {forced[0]}: update_search_type had not got there)"
               if forced else "(entered by update_search_type)")
            + f"; r by round {[r['r'] for r in recs]}")
        if len(ctf_rounds) < 2:
            fail(f"5b: {len(ctf_rounds)} CTF rounds, expected at least two")
        want = sum(max(r["n_phases"]) for r in ctf_rounds)
        got_8 = launches["refine_b"]["likelihood_local_ctf"]
        say(f"  5b: HK8 launches {got_8}, phases of the CTF rounds {want}")
        if got_8 != want:
            fail(f"5b: HK8 launched {got_8} times for {want} phases of CTF search")
        if launches["refine_b"]["symmetrize_ft"] != len(recs) + 1:
            fail(f"5b: HK7 launched {launches['refine_b']['symmetrize_ft']} times in "
                 f"{len(recs)} rounds and the final reconstruction")
        meds = []
        for r in recs:
            meta = read_thu(os.path.join(out, f"Meta_Round_{r['round']:03d}.thu"))
            meds.append(float(np.median(meta.defocus_factor)))
        say(f"  5b: median defocus factor by round {[round(m, 4) for m in meds]} "
            f"(the images' true factor {DEFOCUS_FACTOR})")
        first, last = ctf_rounds[0]["round"], ctf_rounds[-1]["round"]
        if any(m != 1.0 for m in meds[:first]):
            fail("5b: the defocus factor moved before CTF search")
        if not 1.0 + 0.1 * (DEFOCUS_FACTOR - 1) < meds[last] < DEFOCUS_FACTOR + 0.02:
            fail(f"5b: median defocus factor {meds[last]:.4f} after CTF search did not move "
                 f"from 1 toward {DEFOCUS_FACTOR}")
        # the run again from its seed up to its first CTF round (HK3 with
        # a defocus factor a slice, HK8, HK7), the search type set as in
        # the first run
        forced_first = list(forced)
        forced.clear()
        again = rerun(cfg_path, "output_again", first + 1, dev, force_ctf)
        if forced != [i for i in forced_first if i <= first]:
            fail(f"5b: the search type was set at rounds {forced} in the second run, "
                 f"{forced_first} in the first")
        same_runs("5b", out, again, first + 1,
                  lambda i: [f"Reference_000_{h}_Round_{i:03d}.mrc" for h in "AB"])
    return launches["refine_b"], prof


def mkb_run(cfg_path: str, dev, wrappers: dict, rounds: int) -> tuple:
    """configs/demo.json's resumed run with reco_kernel "mkb" set through
    the API (no CLI names it): the CLI's Optimiser, ``rounds`` rounds and
    the final reconstruction, every wrapper's count set to 0 just before
    and read just after.  Returns (launches, records, final maps,
    references after each round)."""
    import torch

    from thunder_tpu_torch.cli.thunder import build_optimiser
    from thunder_tpu_torch.config import ThunderConfig

    cfg = ThunderConfig.from_json(cfg_path)
    cfg.reco_kernel = "mkb"
    opt, _ = build_optimiser(cfg, dev)
    torch.cuda.synchronize()
    for w in wrappers.values():
        w.launches = 0
    recs, refs = [], []
    for i in range(rounds):
        recs.append(opt.run_round(i))
        refs.append(opt.refs_both(report=True))
    final = opt.final_reconstruction()
    torch.cuda.synchronize()
    return {n: w.launches for n, w in wrappers.items()}, recs, final, refs


def phase_refine_mkb(dev, wrappers):
    """Phase 5c: configs/demo.json resumed in local search from the
    generator's blurred poses, as 5b, with the MKB insertion option:
    ROUNDS_MKB rounds and the final reconstruction through the port's
    Optimiser.  Gates: maps finite, res_A finer at the end than at the
    start, the final map's FSC 0.5 against the phantom finer than the
    start model's, HK10 launched and HK3 not, HK7 once a reconstruction,
    and a second run from the same seed equal bit for bit.  Returns the
    launches of the first run."""
    import numpy as np

    from thunder_tpu_torch.io.mrc import read_mrc

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mkb_") as tmp:
        cfg_path, truth = demo_160(tmp, dev, "demo.json", 1, ROUNDS_MKB, LOCAL_START_RES_A,
                                   local_resume=True, defocus_factor=DEFOCUS_FACTOR)
        start, _ = read_mrc(os.path.join(tmp, "start_model.mrc"))
        t0 = time.time()
        launches, recs, final, refs = mkb_run(cfg_path, dev, wrappers, ROUNDS_MKB)
        wall = time.time() - t0
        for rec in recs:
            say(f"  5c round {rec['round']}: r={rec['r']} search {rec['search_type']}->"
                f"{rec['search_type_after']} phases={rec['n_phases']} res={rec['res_A']:.3f} A "
                f"(shell {rec['res_shell']})  {rec['elapsed_s']:.3f} s")
        say(f"  5c wall {wall:.1f} s, launches {launches}")
        if not (np.isfinite(final).all() and all(np.isfinite(r).all() for r in refs)):
            fail("5c: non-finite maps")
        if not recs[-1]["res_A"] < recs[0]["res_A"]:
            fail(f"5c: res_A {recs[-1]['res_A']:.3f} at the end is no finer than "
                 f"{recs[0]['res_A']:.3f} at the start")
        got, was = agreement_res(final[0], truth), agreement_res(start, truth)
        say(f"  5c: the final map agrees with the phantom (FSC 0.5) to {got:.3f} A, the start "
            f"model to {was:.3f} A")
        if not got < was:
            fail(f"5c: the final map's FSC 0.5 against the phantom ({got:.3f} A) is no finer "
                 f"than the start model's ({was:.3f} A)")
        if launches["insert_mkb"] < 2 * (ROUNDS_MKB + 1) or launches["insert_trilinear"]:
            fail(f"5c: HK10 launched {launches['insert_mkb']} times and HK3 "
                 f"{launches['insert_trilinear']}: expected HK10 once a hemisphere a "
                 "reconstruction and HK3 never")
        if launches["symmetrize_ft"] != ROUNDS_MKB + 1:
            fail(f"5c: HK7 launched {launches['symmetrize_ft']} times for "
                 f"{ROUNDS_MKB + 1} reconstructions")
        _, recs2, final2, refs2 = mkb_run(cfg_path, dev, wrappers, ROUNDS_MKB)
        keys = ("r", "res_A", "res_shell", "n_phases", "search_type_after")
        if ([[r[k] for k in keys] for r in recs] != [[r[k] for k in keys] for r in recs2]
                or not all(np.array_equal(a.view(np.int32), b.view(np.int32))
                           for a, b in zip(refs + [final], refs2 + [final2]))):
            fail("5c: a second run from the same seed differs")
        say(f"  5c: a second run from the same seed gave the same records and maps bit for bit "
            f"({ROUNDS_MKB} rounds and the final reconstruction)")
    return launches


def phase_parity(dev, wrappers):
    """Phase 9: whole runs of the port on the card held to thunder_tpu's
    committed record on the same files (written by the generator on the
    CPU): as many rounds, each with its r and search type and its
    FSC-0.143 shell within one.  Returns the launches summed over the
    cases."""
    import torch

    from thunder_tpu_torch.micro import run_parity

    launches = {n: 0 for n in wrappers}
    for name in PARITY_CASES:
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        got = run_parity.run_case(name, "cuda")
        torch.cuda.synchronize()
        for n, w in wrappers.items():
            launches[n] += w.launches
        say(f"  9 case {name} ({len(got['rounds'])} rounds, {time.time() - t0:.1f} s; "
            f"thunder_tpu's record from {got['ref_cpu']}), port / thunder_tpu:")
        for line in got["lines"]:
            say("    " + line)
        if got["bad"] or not got["held"]:
            fail(f"9 case {name}: rounds {got['bad']} part from thunder_tpu's (a shell more "
                 "than one apart, another r or search type, or a round only one run has)")
    return launches


def phase_classify_3d(dev, wrappers):
    """configs/demo_3D.json's classification (K = 4, C4) for ROUNDS_3D
    rounds on two sharp C4 species, round PROFILE_K4 under the profiler."""
    import numpy as np

    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.recon.reconstructor import symmetrize_ft

    with tempfile.TemporaryDirectory(prefix="chip_smoke_3d_classes_") as tmp:
        cfg_path, _ = demo_160(tmp, dev, "demo_3D.json", 2, ROUNDS_3D, INIT_MODEL_RES_A)
        truth = np.load(os.path.join(tmp, "truth.npy"))
        launches, recs, out, seen, prof = run_160("6", dev, wrappers, cfg_path, PROFILE_K4)
        check_global_launches("6 (K = 4)", seen)
        check_maps("6", out, len(recs), K_3D)
        if len(recs) != ROUNDS_3D:
            fail(f"6: {len(recs)} round records, expected {ROUNDS_3D}")
        if launches["symmetrize_ft"] != ROUNDS_3D + 1 or symmetrize_ft.last_grids != 2 * K_3D:
            fail(f"6: HK7 launched {launches['symmetrize_ft']} times over "
                 f"{symmetrize_ft.last_grids} grids, expected one launch over {2 * K_3D} grids "
                 f"in each of {ROUNDS_3D} rounds and the final reconstruction")
        purities = []
        for i in range(ROUNDS_3D):
            meta = read_thu(os.path.join(out, f"Meta_Round_{i:03d}.thu"))
            idx = np.array([int(p.split("@")[0]) - 1 for p in meta.particle_path])
            cls = np.asarray(meta.class_id)
            purities.append(purity(cls, truth[idx], K_3D))
            say(f"  6 round {i}: purity {purities[-1]:.4f}, class sizes "
                f"{np.bincount(cls, minlength=K_3D).tolist()}, reborn "
                f"{recs[i].get('reborn_classes', [])}")
        share = float(max(np.mean(truth == 0), np.mean(truth == 1)))
        say(f"  6: purity gate 1.5/K = {1.5 / K_3D:.4f}; with two species a blind split "
            f"already reads {share:.4f}")
        if not purities[-1] > 1.5 / K_3D:
            fail(f"6: class purity {purities[-1]:.4f} not above 1.5/K = {1.5 / K_3D:.4f}")
        prof["purity"] = purities
    return launches, prof



def post_records(dev, tmp: str, meta_path: str, fit_shells: int) -> dict:
    """HK1, HK3 and HK4 against their plain versions at phase 7's new
    shapes, timed with their bounds: HK1 as save_subtract launches it
    (a hemisphere's 512 images, one pose each, over all 160^2 pixels of
    the box, from the 320^3 padded cube of the phantom; its taps clip at
    the cube's faces at the image corners, which the subtraction zeroes),
    HK3 as thunder_reconstruct launches it (the dataset's images at the
    poses of ``meta_path``, r_u 78, into 320^3) and HK4's coordinate form
    over every cell of a 160^3 spectrum, as the B-factor fit of
    thunder_postprocess launches it (``fit_shells`` shells)."""
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.io.loader import load_images
    from thunder_tpu_torch.io.mrc import read_mrc
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.ops import insert, projector
    from thunder_tpu_torch.ops.fourier import fft2_centered, fft3_centered
    from thunder_tpu_torch.physics import spectrum
    from thunder_tpu_torch.physics.ctf import ctf_params

    gen = generator(7, dev)
    size, pf, n_l = SIZE_R, 2, N_POST // 2
    out = {}
    vol = torch.as_tensor(read_mrc(os.path.join(tmp, "init_model.mrc"))[0], device=dev)
    table = projector.prepare_projectee_3d(vol, pf).ft[None].contiguous()
    k = torch.arange(size, dtype=torch.int32, device=dev) - size // 2
    ky, kx = (g.reshape(-1) for g in torch.meshgrid(k, k, indexing="ij"))
    n_p = kx.numel()
    tail = (rotate3d(random_quat(gen, (n_l, 1), dev)), kx, ky, pf,
            torch.zeros(n_l, dtype=torch.long, device=dev))
    call = lambda: projector.project_slices(table, *tail)
    got, ref = call(), projector.project_slices_plain(table, *tail)
    shape = f"subtract L={n_l} R=1 P={n_p} from the {size * pf}^3 cube"
    err = compare("project_slices", shape, got, ref, 1e-5,
                  "same coordinates and tap order; the sums may contract into FMAs")
    lib, lib_out = grid_sample_call(table, *tail)
    inside = (kx * kx + ky * ky < (size // 2 - 1) ** 2)
    compare("grid_sample (HK1's library yardstick)", "inside the radius the subtraction keeps",
            lib_out(lib())[..., inside], got[..., inside], 1e-4,
            "border clamps the coordinate where HK1 clamps each tap")
    del got, ref
    out["project_slices"] = record(
        "project_slices", shape, err, timed(call, 10),
        timed(lambda: projector.project_slices_plain(table, *tail), 2, warm=1),
        table.numel() * 8 + n_l * 36 + 8 * n_p + 4 * n_l + n_l * n_p * 8, n_l * n_p * 60,
        library_ms=timed(lib, 5))
    del table, lib, vol

    meta = read_thu(meta_path)
    n_s = len(meta)
    imgs = load_images(meta, tmp + "/")
    ft = fft2_centered(torch.as_tensor(imgs, device=dev)).to(torch.complex64).contiguous()
    ctf = ctf_params(meta.voltage, meta.defocus_u, meta.defocus_v, meta.defocus_theta, meta.cs,
                     meta.amplitude_contrast, meta.phase_shift, device=dev)
    r_u, big = size // 2 - 2, size * pf
    some = (ft, ctf, torch.arange(n_s, device=dev),
            rotate3d(torch.as_tensor(meta.quat, dtype=torch.float32, device=dev)),
            torch.as_tensor(meta.trans, dtype=torch.float32, device=dev),
            torch.full((n_s,), 1.0 / n_s, device=dev), r_u, pf, size, PIXEL_SIZE)
    zeros = lambda: (torch.zeros((big,) * 3, dtype=torch.complex64, device=dev),
                     torch.zeros((big,) * 3, device=dev))
    (fk, tk), ((fp, tp), plain_ms) = (insert.insert_trilinear(*some, big),
                                      timed_once(lambda: insert.insert_trilinear_plain(
                                          *some, *zeros())))
    shape = f"reconstruct slices={n_s} r_u={r_u} big={big}^3"
    same_bits("insert_trilinear", shape, (fk, tk), insert.insert_trilinear(*some, big))
    err = max(compare("insert_trilinear", f"F {shape}", torch.view_as_real(fk),
                      torch.view_as_real(fp), 1e-4, GATHER_WHY),
              compare("insert_trilinear", "T", tk, tp, 1e-4, GATHER_WHY))
    del fk, tk, fp, tp
    npx = int((insert.dense_window(r_u)[2] > 0).sum())
    out["insert_trilinear"] = record(
        "insert_trilinear", shape, err, timed(lambda: insert.insert_trilinear(*some, big), 3),
        plain_ms, n_s * npx * 8 + n_s * 32 + n_s * 64 + big ** 3 * 12, n_s * npx * 110)
    del ft, some

    avg = read_mrc(os.path.join(tmp, "pp_mask_Reference_Average.mrc"))[0]
    vals = fft3_centered(torch.as_tensor(avg, device=dev)).abs().reshape(1, 1, -1).contiguous()
    n = vals.shape[-1]
    u, _ = spectrum.shell_geometry(size, 3, dev)
    call = lambda: spectrum.shell_sums_grid(vals, size, 3, fit_shells, False)
    ref = spectrum.shell_sums_grid_plain(vals, size, 3, fit_shells, False)
    shape = f"full space B=1 C=1 N={size}^3 shells={fit_shells}"
    why = "float32 sums in another order (fixed: two calls give identical bits)"
    got = call()
    same_bits("shell_sums", shape, got, call())
    err = compare("shell_sums", shape, got, ref, 1e-4, why)
    lib, lib_out = bincount_call(vals, u, fit_shells, None)
    compare("bincount (HK4's library yardstick)", shape, lib_out(lib()), ref, 1e-4,
            "float32 sums in another order")
    out["shell_sums"] = record(
        "shell_sums", shape, err, timed(call, 50),
        timed(lambda: spectrum.shell_sums_grid_plain(vals, size, 3, fit_shells, False), 5),
        4 * n + 4 * fit_shells, 2 * n, library_ms=timed(lib, 20), alone=call)
    return out


def left_out_share(dev, truth, mask, disc) -> float:
    """The share of the phantom's projected power, inside ``disc``, that
    ``mask`` leaves out: the phantom and the phantom times (1 - mask),
    padded and projected at 64 random poses over every pixel by HK1's
    plain version (no launch is counted), zero past the box's half
    width."""
    import torch

    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.ops.fourier import ifft2_centered
    from thunder_tpu_torch.ops.projector import prepare_projectee_3d, project_slices_plain

    size = truth.shape[-1]
    t = torch.as_tensor(truth, device=dev)
    table = torch.stack([prepare_projectee_3d(v, 2).ft
                         for v in (t, t * (1 - torch.as_tensor(mask, device=dev)))])
    k = torch.arange(size, device=dev) - size // 2
    ky, kx = (g.reshape(-1) for g in torch.meshgrid(k, k, indexing="ij"))
    rot = rotate3d(random_quat(generator(3, dev), (1, 64), dev)).expand(2, 64, 3, 3)
    ft = project_slices_plain(table, rot, kx, ky, 2, torch.arange(2, device=dev))
    ft = torch.where(kx * kx + ky * ky < (size // 2 - 1) ** 2, ft, torch.zeros_like(ft))
    img = ifft2_centered(ft.reshape(2, 64, size, size))[..., torch.as_tensor(disc, device=dev)]
    return float((img[1] ** 2).sum() / (img[0] ** 2).sum())


def phase_post(dev, wrappers):
    """Phase 7: the post-refinement paths through their CLIs on one 160 px
    dataset (N_POST images of the sharp C4 phantom, SNR_POST): 7a
    ``tools genmask`` of the phantom; 7b configs/demo.json resumed in
    local search for ROUNDS_POST rounds with that mask and signal
    subtraction; 7c ``reconstruct --sym C4`` from 7b's last .thu; 7d
    ``postprocess`` of 7b's half maps with the mask and with the
    auto-mask; 7e ``project`` of the phantom at N_PROJ random poses, then
    ``reconstruct --no-ctf``; 7f the volume tools on 7b's maps and
    ``star_convert`` there and back (see N_POST for the subtraction's
    expected power).  Every count is set to 0 before 7a
    and read after 7f; then the kernel records at the new shapes.
    Returns (launches, records, step walls)."""
    import contextlib
    import io
    import re

    import numpy as np
    import torch

    from thunder_tpu_torch.cli import postprocess as cli_post
    from thunder_tpu_torch.cli import project as cli_project
    from thunder_tpu_torch.cli import reconstruct as cli_reco
    from thunder_tpu_torch.cli import star_convert, thunder, tools
    from thunder_tpu_torch.io.mrc import MrcFile, read_mrc
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.optimiser import Optimiser
    from thunder_tpu_torch.physics.mask import radial_grid
    from thunder_tpu_torch.physics.spectrum import res_a2p, shell_sums
    from thunder_tpu_torch.postprocess import B_FACTOR_EST_LOW_RES
    from thunder_tpu_torch.recon import reconstructor as rc

    walls, steps = {}, {}
    dv = ["--device", str(dev)]

    def step(name, fn):
        torch.cuda.synchronize()
        before = {k: w.launches for k, w in wrappers.items()}
        t0 = time.time()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn()
        torch.cuda.synchronize()
        walls[name] = time.time() - t0
        steps[name] = {k: w.launches - before[k] for k, w in wrappers.items()}
        say(f"  7{name}: {walls[name]:.2f} s, launches "
            f"{ {k: c for k, c in steps[name].items() if c} }")
        if rc not in (None, 0):
            fail(f"7{name}: returned {rc}")
        return buf.getvalue()

    def finite_volume(label, path, shape):
        v, _ = read_mrc(path)
        if v.shape != shape or not np.isfinite(v).all():
            fail(f"{label}: {os.path.basename(path)} has shape {v.shape} (expected {shape}) "
                 "or non-finite values")
        return v

    with tempfile.TemporaryDirectory(prefix="chip_smoke_post_") as tmp:
        j = lambda *p: os.path.join(tmp, *p)
        cfg_path, truth = demo_160(tmp, dev, "demo.json", 1, ROUNDS_POST, LOCAL_START_RES_A,
                                   local_resume=True, snr=SNR_POST, n=N_POST)
        box = (SIZE_R,) * 3
        torch.cuda.synchronize()
        for w in wrappers.values():
            w.launches = 0
        shell_sums.shapes.clear()

        step("a tools genmask", lambda: tools.main(
            ["genmask", "-i", j("init_model.mrc"), "-o", j("mask.mrc")] + dv))
        mask = finite_volume("7a", j("mask.mrc"), box)
        inside = float((truth[mask >= 0.5] ** 2).sum() / (truth ** 2).sum())
        say(f"  7a: mask of {int((mask >= 0.5).sum())} voxels at 0.5 or more, values in "
            f"[{mask.min():.3f}, {mask.max():.3f}], holding {inside:.4f} of the phantom's "
            "power (the largest connected part)")
        if not (mask.max() == 1.0 and mask.min() >= 0.0 and inside > 0.1):
            fail("7a: the auto-mask is not a [0, 1] mask around the phantom's density")

        with open(cfg_path) as f:
            cfg = json.load(f)
        cfg["Reference Mask"].update({"Perform Reference Mask": True,
                                      "Provided Mask": j("mask.mrc")})
        cfg["Subtract"]["Subtract Masked Region Reference From Images"] = True
        with open(cfg_path, "w") as f:
            json.dump(cfg, f, indent=2)
        save_subtract, sub = Optimiser.save_subtract, {}

        def counted(self, m, chunk=512):
            before = wrappers["project_slices"].launches
            res = save_subtract(self, m, chunk)
            sub["hk1"], sub["n_img"] = wrappers["project_slices"].launches - before, self.n_img
            return res

        Optimiser.save_subtract = counted
        try:
            step("b thunder", lambda: thunder.main([cfg_path] + dv))
        finally:
            Optimiser.save_subtract = save_subtract
        out = j("output")
        with open(os.path.join(out, "round_metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        for rec in recs:
            say(f"  7b round {rec['round']}: r={rec['r']} search {rec['search_type']}->"
                f"{rec['search_type_after']} phases={rec['n_phases']} res={rec['res_A']:.3f} A  "
                f"{rec['elapsed_s']:.3f} s")
        check_maps("7b", out, len(recs), 1)
        meta_path = os.path.join(out, f"Meta_Round_{len(recs) - 1:03d}.thu")
        stack = os.path.join(out, "Subtract.mrcs")
        if not (os.path.exists(stack) and os.path.exists(os.path.join(out, "Subtract.thu"))):
            fail("7b: Subtract.mrcs or Subtract.thu not written")
        sub_mrc = MrcFile(stack)
        if (sub_mrc.nz, sub_mrc.ny, sub_mrc.nx) != (N_POST, SIZE_R, SIZE_R):
            fail(f"7b: Subtract.mrcs holds {(sub_mrc.nz, sub_mrc.ny, sub_mrc.nx)}")
        subtracted = sub_mrc.read_slices(list(range(N_POST)))
        if not np.isfinite(subtracted).all():
            fail("7b: Subtract.mrcs has non-finite values")
        s_thu, meta = read_thu(os.path.join(out, "Subtract.thu")), read_thu(meta_path)
        if s_thu.particle_path != [f"{i + 1}@{stack}" for i in range(N_POST)]:
            fail("7b: Subtract.thu entry i does not name slice i of Subtract.mrcs")
        if not np.array_equal(s_thu.quat, meta.quat):
            fail("7b: Subtract.thu does not carry the last round's poses")
        want_hk1 = 2 * -(-sub.get("n_img", 0) // 512)
        say(f"  7b: save_subtract launched HK1 {sub.get('hk1')} times "
            f"({sub.get('n_img')} images a hemisphere, 512 a launch: {want_hk1})")
        if sub.get("hk1") != want_hk1 or want_hk1 == 0:
            fail(f"7b: save_subtract launched HK1 {sub.get('hk1')} times, expected {want_hk1}")
        orig = MrcFile(j("particles.mrcs")).read_slices(
            [int(p.split("@")[0]) - 1 for p in meta.particle_path])
        disc = radial_grid(SIZE_R, 2) < cfg["Basic"]["Radius of Mask on Images (Angstrom)"] / PIXEL_SIZE
        p_orig = float((orig[:, disc] ** 2).mean())
        ratio = float((subtracted[:, disc] ** 2).mean()) / p_orig
        f_out = left_out_share(dev, truth, mask, disc)
        want = (1 + f_out * (p_orig - 1)) / p_orig
        gate = want + SUBTRACT_ADD
        say(f"  7b: mean power a pixel inside the image mask: originals {p_orig:.3f} (noise 1), "
            f"subtracted / originals {ratio:.5f}; the mask leaves out {f_out:.4f} of the "
            f"phantom's projected power, so expected {want:.5f}; gate {gate:.5f}")
        if not ratio <= gate:
            fail(f"7b: subtracted images keep {ratio:.4f} of the originals' power inside the "
                 f"mask, more than {gate:.4f}")
        del subtracted, orig

        grids, reco_fn = {}, rc.reconstruct

        def keep_grids(f_grid, t_grid, *args, **kwargs):
            grids["f"], grids["t"] = f_grid, t_grid
            return reco_fn(f_grid, t_grid, *args, **kwargs)

        rc.reconstruct = keep_grids
        try:
            step("c reconstruct", lambda: cli_reco.main(
                ["--thu", meta_path, "-o", j("reco_c4.mrc"), "--size", str(SIZE_R),
                 "--pixelsize", str(PIXEL_SIZE), "--prefix", tmp + "/", "--sym", "C4"] + dv))
        finally:
            rc.reconstruct = reco_fn
        if not (steps["c reconstruct"]["insert_trilinear"] >= 1
                and steps["c reconstruct"]["symmetrize_ft"] == 1):
            fail(f"7c: HK3 or HK7 not launched: {steps['c reconstruct']}")
        reco = finite_volume("7c", j("reco_c4.mrc"), box)
        final = read_mrc(os.path.join(out, "Reference_000_Final.mrc"))[0]
        sh_c, sh_b = agreement_shell(reco, truth), agreement_shell(final, truth)
        res_c = SIZE_R * PIXEL_SIZE / sh_c
        say(f"  7c: FSC-0.5 against the phantom: reconstruct shell {sh_c} ({res_c:.3f} A), "
            f"7b's Reference_000_Final shell {sh_b} ({SIZE_R * PIXEL_SIZE / sh_b:.3f} A)")
        band_edge_report(grids.pop("f"), grids.pop("t"), truth)
        if not res_c < 12.0:
            fail(f"7c: the map agrees with the phantom to {res_c:.2f} A, not finer than 12 A")
        if abs(sh_c - sh_b) > CROSSING_SPREAD:
            fail(f"7c: reconstruct's crossing is at shell {sh_c}, 7b's final map's at {sh_b}: "
                 f"more than {CROSSING_SPREAD} apart")

        fit = {}
        shell_sums.shapes.clear()
        for tag, extra in (("mask", ["-m", j("mask.mrc")]), ("auto", [])):
            line = step(f"d postprocess ({tag})", lambda: cli_post.main(
                ["-a", os.path.join(out, "Reference_000_A_Final.mrc"),
                 "-b", os.path.join(out, "Reference_000_B_Final.mrc"), "--pixelsize",
                 str(PIXEL_SIZE), "--out-prefix", j(f"pp_{tag}_")] + extra + dv)).strip()
            say(f"  7d ({tag}): {line}")
            m = re.match(r"resolution: (\S+) A \(shell (\d+)\), B factor: (\S+)", line)
            if m is None:
                fail(f"7d ({tag}): no result line")
            res_a, shell, b_fac = float(m.group(1)), int(m.group(2)), float(m.group(3))
            fsc = np.loadtxt(j(f"pp_{tag}_Postprocess_FSC.txt"))
            if fsc.shape != (SIZE_R // 2 - 2, 5) or not np.isfinite(fsc).all():
                fail(f"7d ({tag}): Postprocess_FSC.txt has shape {fsc.shape} or non-finite "
                     "values (expected shells 1-78, five columns)")
            finite_volume(f"7d ({tag})", j(f"pp_{tag}_Reference_Sharp.mrc"), box)
            if not (res_a < 10.0 and np.isfinite(b_fac)):
                fail(f"7d ({tag}): resolution {res_a} A not finer than 10 A or B factor "
                     f"{b_fac} not finite")
            low = int(round(res_a2p(1.0 / B_FACTOR_EST_LOW_RES, SIZE_R, PIXEL_SIZE)))
            fit[tag] = max(shell, low + 2)
        forms = {key[0] for key in shell_sums.shapes}
        say(f"  7d: HK4 launches by (form, B, C, N): {dict(shell_sums.shapes)}")
        if not {"pair", "full"} <= forms:
            fail(f"7d: HK4's pair and full-space forms not both launched: {sorted(forms)}")

        n_before = wrappers["project_slices"].launches
        step("e project", lambda: cli_project.main(
            ["-i", j("init_model.mrc"), "-o", j("proj.mrcs"), "-n", str(N_PROJ), "--save-thu",
             j("proj.thu")] + dv))
        if wrappers["project_slices"].launches - n_before != -(-N_PROJ // 512):
            fail(f"7e: project launched HK1 {wrappers['project_slices'].launches - n_before} "
                 f"times for {N_PROJ} images, 512 a launch")
        step("e reconstruct --no-ctf", lambda: cli_reco.main(
            ["--thu", j("proj.thu"), "-o", j("reco_proj.mrc"), "--size", str(SIZE_R),
             "--pixelsize", str(PIXEL_SIZE), "--no-ctf"] + dv))
        rp = finite_volume("7e", j("reco_proj.mrc"), box)
        inner = radial_grid(SIZE_R, 3) < SIZE_R // 2 - 4
        corr = float(np.corrcoef(rp[inner], truth[inner])[0, 1])
        say(f"  7e: project -> reconstruct correlation with the phantom inside r < "
            f"{SIZE_R // 2 - 4}: {corr:.5f} (gate 0.95)")
        if not corr > 0.95:
            fail(f"7e: correlation {corr:.4f} with the phantom, not above 0.95")

        a_map, b_map = (os.path.join(out, f"Reference_000_{h}_Final.mrc") for h in "AB")
        small = (128,) * 3
        for name, argv, shape in (
                ("lowpass", ["-i", a_map, "-o", j("t_lp.mrc"), "--res", "8", "--pixelsize",
                             str(PIXEL_SIZE)], box),
                ("bfactor", ["-i", a_map, "-o", j("t_bf.mrc"), "--bfactor", "60"], box),
                ("resize", ["-i", a_map, "-o", j("t_128.mrc"), "--size", "128"], small),
                ("resize", ["-i", j("t_128.mrc"), "-o", j("t_160.mrc"), "--size",
                            str(SIZE_R)], box),
                ("mask", ["-i", a_map, "-o", j("t_mask.mrc"), "--mask", j("mask.mrc")], box),
                ("average", ["-i", a_map, b_map, "-o", j("t_avg.mrc")], box),
                ("minus", ["-a", a_map, "-b", b_map, "-o", j("t_minus.mrc")], box),
                ("alignz", ["-i", a_map, "-o", j("t_alignz.mrc")], box),
                ("genmask_shell", ["-o", j("t_shell.mrc"), "--size", str(SIZE_R), "--rin",
                                   "20", "--rout", "60", "--pixelsize", str(PIXEL_SIZE)], box)):
            label = f"f tools {name}" + (f" to {argv[-1]}" if name == "resize" else "")
            step(label, lambda: tools.main([name] + argv + dv))
            finite_volume(f"7f tools {name}", argv[argv.index("-o") + 1], shape)
        shown = step("f tools view", lambda: tools.main(["view", "-i", a_map] + dv))
        if f"shape={box}" not in shown:
            fail(f"7f tools view printed {shown[:200]!r}")
        step("f star_convert", lambda: (
            star_convert.main(["thu2star", "-i", meta_path, "-o", j("meta.star"),
                               "--pixelsize", str(PIXEL_SIZE)])
            or star_convert.main(["star2thu", "-i", j("meta.star"), "-o", j("back.thu")])))
        back = read_thu(j("back.thu"))
        dq = np.abs(np.abs(np.sum(back.quat * meta.quat, axis=1)) - 1).max()
        errs = {"quat": dq, "trans": np.abs(back.trans - meta.trans).max()}
        for f_ in ("voltage", "defocus_u", "defocus_v", "defocus_theta", "cs",
                   "amplitude_contrast", "phase_shift"):
            a_, b_ = getattr(back, f_), getattr(meta, f_)
            errs[f_] = float(np.abs(a_ - b_).max() / max(np.abs(b_).max(), 1.0))
        say(f"  7f star round trip, largest errors: {json.dumps(errs, default=float)}")
        if back.particle_path != meta.particle_path or max(errs.values()) > 1e-4:
            fail("7f: thu -> star -> thu did not give back the poses and CTFs within 1e-4")

        launches = {name: w.launches for name, w in wrappers.items()}
        say(f"  phase 7 launches {launches}; walls {json.dumps(walls, default=float)}")
        for name in ("project_slices", "insert_trilinear", "shell_sums", "symmetrize_ft"):
            if launches[name] <= 0:
                fail(f"phase 7: {name} never launched")
        say("  phase 7 kernel records at the new shapes")
        recs_post = post_records(dev, tmp, meta_path, fit["mask"])
    return launches, recs_post, walls

# -- phase 8: ranks ----------------------------------------------------


def kernel_wrappers() -> dict:
    """Every hand kernel's wrapper by name (each counts its launches)."""
    from thunder_tpu_torch.ops.insert import (insert_bilinear_2d, insert_mkb, insert_trilinear,
                                              insert_trilinear_slab)
    from thunder_tpu_torch.ops.likelihood import likelihood_block, likelihood_local_ctf
    from thunder_tpu_torch.ops.projector import project_slices, project_slices_2d
    from thunder_tpu_torch.physics.spectrum import shell_sums
    from thunder_tpu_torch.recon.reconstructor import symmetrize_ft

    return {f.__name__: f for f in (project_slices, likelihood_block, insert_trilinear,
                                    shell_sums, project_slices_2d, insert_bilinear_2d,
                                    symmetrize_ft, likelihood_local_ctf,
                                    insert_trilinear_slab, insert_mkb)}


def run_ranks(kind: str, spec: dict, world: int) -> list:
    """``world`` processes of this script, each one rank of phase 8's
    ``kind`` (rank_entry), joined over a free local port; fails the
    script when any rank fails or RANK_TIMEOUT_S passes (the others are
    stopped).  Returns each rank's report, rank order."""
    from thunder_tpu_torch.cli.thunder import free_port

    spec_path = os.path.join(spec["dir"], f"{spec['tag']}.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    port = free_port()
    logs = [open(os.path.join(spec["dir"], f"{spec['tag']}_rank{r}.log"), "w")
            for r in range(world)]
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen([sys.executable, os.path.join(here, "chip_smoke.py"), "--rank",
                               kind, spec_path, str(r), str(world), str(port)],
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    t0, bad = time.time(), None
    while bad is None and any(p.poll() is None for p in procs):
        bad = next((r for r, p in enumerate(procs) if p.returncode not in (None, 0)), None)
        if time.time() - t0 > RANK_TIMEOUT_S:
            bad = -1
        time.sleep(0.2)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    for f in logs:
        f.close()
    bad = bad if bad is not None else next((r for r, p in enumerate(procs) if p.returncode), None)
    if bad is not None:
        r = max(bad, 0)
        with open(os.path.join(spec["dir"], f"{spec['tag']}_rank{r}.log")) as f:
            tail = f.read()[-4000:]
        fail(f"phase 8 {spec['tag']}: " + (f"ranks still running after {RANK_TIMEOUT_S} s"
                                           if bad < 0 else f"rank {r} exited "
                                           f"{procs[r].returncode}") + f"; its log ends:\n{tail}")
    out = []
    for r in range(world):
        with open(os.path.join(spec["dir"], f"{spec['tag']}_rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def rank_entry(kind: str, spec_path: str, rank: int, world: int, port: int) -> None:
    """One rank of phase 8 (this script run with --rank): every kernel's
    count and the collectives' counts at 0, the rank's part, then its
    report (launches, collectives, peak memory, what the part returns)
    written beside the spec."""
    import logging

    import torch

    from thunder_tpu_torch.parallel import comm

    with open(spec_path) as f:
        spec = json.load(f)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    comm.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    if kind == "cli":
        from thunder_tpu_torch.cli import thunder

        lines = []

        class Keep(logging.Handler):
            def emit(self, rec):
                lines.append(rec.getMessage())

        logging.getLogger("thunder").addHandler(Keep())
        flags = (["--no-mesh"] if world == 1 else
                 ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
                  "--process-id", str(rank)])
        rc = thunder.main([spec["cfg"], "--device", "cuda"] + flags)
        if rc != 0:
            fail(f"rank {rank}: thunder main returned {rc}")
        loaded = [m for m in lines if m.startswith(("loading ", f"rank {rank} loaded"))]
        report = dict(loaded=int(loaded[0].split()[3 if world > 1 else 1]),
                      layout=next((m for m in lines if m.startswith(f"rank {rank}/")),
                                  f"rank 0/1 one process, device {torch.cuda.current_device()}"))
    else:
        import torch.distributed as dist

        from thunder_tpu_torch.parallel.distributed import default_mesh, init_multihost

        init_multihost(f"127.0.0.1:{port}", world, rank, "cuda")
        lay = default_mesh(device="cuda")
        report = dict(layout=lay.describe(), **RANK_PARTS[kind](lay, spec))
        dist.destroy_process_group()
    torch.cuda.synchronize()
    report.update(rank=rank, wall_s=time.time() - t0,
                  launches={n: w.launches for n, w in wrappers.items()},
                  comm=comm.STATS, peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    with open(os.path.join(spec["dir"], f"{spec['tag']}_rank{rank}.json"), "w") as f:
        json.dump(report, f)


def _slab_round_part(lay, spec) -> dict:
    """8b on one rank: the Optimiser at vol_shard_min_mb 0 from the
    config's data, the injected draws' rows of this rank, a round's maps
    through the slab path; rank j = 0 of each hemisphere saves them."""
    import numpy as np
    import torch

    from thunder_tpu_torch import particle as pt
    from thunder_tpu_torch.cli import thunder
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.optimiser import reco_grid_size

    cfg = ThunderConfig.from_json(spec["cfg"])
    cfg.vol_shard_min_mb = 0
    opt, _ = thunder.build_optimiser(cfg, lay.device, lay)
    z = np.load(spec["draws"])
    draws = tuple(torch.as_tensor(np.ascontiguousarray(lay.take(z[k])), device=lay.device)
                  for k in ("quats", "trans", "d", "w"))
    opt.state.par = pt.cal_score(opt.state.par, opt.mode)
    grid = reco_grid_size(cfg.size, int(opt.model.r_u))
    if not opt._vol_sharded(grid):
        fail(f"8b: rank {lay.rank} did not route a {grid * cfg.pf}^3 grid to the slab path")
    torch.cuda.synchronize()
    t0 = time.time()
    fsc, mp, r_u = opt.reconstruct_maps(draws)
    torch.cuda.synchronize()
    if lay.j == 0:
        np.savez(os.path.join(spec["dir"], f"{spec['tag']}_h{lay.h}.npz"),
                 fsc=fsc[0].cpu().numpy(), map=mp[0].cpu().numpy())
    return dict(ms=(time.time() - t0) * 1e3, big=grid * cfg.pf, r_u=r_u)


def _slab_big_part(lay, spec) -> dict:
    """8c on one rank: its images' dense-window values formed, gathered
    over the data group, HK9 into this rank's z-slab of the 640^3 grid
    with C4's mates, then the MAP-free reconstruction on slabs."""
    import numpy as np
    import torch

    from thunder_tpu_torch.geometry.quaternion import rotate3d
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.ops.insert import dense_slice_values, insert_trilinear_slab
    from thunder_tpu_torch.parallel import comm
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.recon.sharded import reconstruct_all_sharded, sharded_grid_specs

    dev, n = lay.device, spec["n"]
    index = np.stack([np.arange(0, n, 2), np.arange(1, n, 2)])
    ids = np.ascontiguousarray(lay.take(index)).reshape(-1)
    ft = torch.as_tensor(np.load(spec["ft"], mmap_mode="r")[ids], device=dev)
    cols = np.load(spec["ctf"])[:, ids]
    quats = torch.as_tensor(np.load(spec["quats"])[ids], device=dev)
    size, r_u, big = spec["size"], spec["r_u"], 2 * spec["size"]
    torch.cuda.synchronize()
    t0 = time.time()
    m = len(ids)
    vals, c2w, _, _ = dense_slice_values(
        ft, ctf_params(*cols, device=dev), torch.arange(m, device=dev),
        torch.zeros(m, 2, device=dev), torch.ones(m, device=dev), r_u, size, PIXEL_SIZE)
    del ft
    gather = lambda x: comm.gather_slabs(lay, x.contiguous(), axis=0)
    vals, c2w, rot = gather(vals), gather(c2w), gather(rotate3d(quats))
    z0, bz = sharded_grid_specs(lay, big)
    f, t = insert_trilinear_slab(vals, c2w, rot, torch.zeros(rot.shape[0], dtype=torch.int32,
                                                               device=dev),
                                 r_u, 2, Symmetry("C4", dev).matrices, 1, big, z0, bz)
    del vals, c2w
    torch.cuda.synchronize()
    t_insert = time.time() - t0
    vol = reconstruct_all_sharded(lay, f, t, None, size, 2, r_u, False, False, size)
    torch.cuda.synchronize()
    if lay.j == 0:
        np.save(os.path.join(spec["dir"], f"slab_big_h{lay.h}.npy"), vol[0].cpu().numpy())
    return dict(insert_s=t_insert, total_s=time.time() - t0, slab=[bz, big, big])


RANK_PARTS = {"slab_round": _slab_round_part, "slab_big": _slab_big_part}


def _rel_l2(a, b) -> float:
    import numpy as np

    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank_lines(label: str, ranks: list) -> None:
    for r in ranks:
        said = {k: v for k, v in r["launches"].items() if v}
        loaded = f"loaded {r['loaded']} images, " if "loaded" in r else ""
        say(f"  {label} {r['layout']}: {loaded}wall {r['wall_s']:.2f} s, peak "
            f"{r['peak_gb']:.3f} GB, launches {said}")
        say(f"  {label} rank {r['rank']} collectives (calls, bytes, staged bytes): "
            + json.dumps({k: [v['calls'], v['bytes'], v['staged_bytes']]
                          for k, v in r['comm'].items()}))


class separable_fft:
    """Within the block torch.fft.rfftn / irfftn run as their separable
    composition (an rfft over the last axis and a complex FFT over the
    others), as the slab path composes its transforms: the same function
    rounded another way."""

    def __enter__(self):
        import torch

        self.saved = torch.fft.rfftn, torch.fft.irfftn

        def rfftn(x, s=None, dim=None, norm=None):
            return torch.fft.fftn(torch.fft.rfft(x, dim=dim[-1]), dim=dim[:-1])

        def irfftn(x, s=None, dim=None, norm=None):
            return torch.fft.irfft(torch.fft.ifftn(x, dim=dim[:-1]), n=s[-1], dim=dim[-1])

        torch.fft.rfftn, torch.fft.irfftn = rfftn, irfftn
        return self

    def __exit__(self, *exc):
        import torch

        torch.fft.rfftn, torch.fft.irfftn = self.saved


def band_split(a, b, shell: float) -> tuple:
    """L2 of a - b (real FFT-layout maps) over |b|'s, split at Fourier
    shell ``shell``: (below, at or beyond)."""
    import numpy as np

    from thunder_tpu_torch.physics.mask import radial_grid

    d = np.fft.fftn(a - b)
    inside = radial_grid(a.shape[-1], 3) < shell
    norm = np.linalg.norm(np.fft.fftn(b))
    return (float(np.linalg.norm(d[inside]) / norm), float(np.linalg.norm(d[~inside]) / norm))


def hk9_record(label: str, dev, vals, c2w, rot, r_u: int, big: int, bz: int, mats) -> dict:
    """HK9 against its plain twin on the first slab of ``big``^3 (and
    against itself: two calls identical), timed (kernel with CUDA events;
    the twin once), with its bound: the slab's F and T written once and
    the slices read once, against every mate's rotation and 8 taps."""
    import torch

    from thunder_tpu_torch.ops import insert

    n_s = rot.shape[0]
    cls = torch.zeros(n_s, dtype=torch.int32, device=dev)
    k = lambda: insert.insert_trilinear_slab(vals, c2w, rot, cls, r_u, 2, mats, 1, big, 0, bz)
    f, t = k()
    shape = f"{label}: slices={n_s} nk^2={vals.shape[1]} mates={mats.shape[0]} slab={bz}x{big}^2"
    same_bits("insert_trilinear_slab", shape, (f, t), k())
    (fp, tp), plain_ms = timed_once(lambda: insert.insert_trilinear_slab_plain(
        vals, c2w, rot, cls, r_u, 2, mats,
        torch.zeros((1, bz, big, big), dtype=torch.complex64, device=dev),
        torch.zeros((1, bz, big, big), device=dev), 0))
    err = max(compare("insert_trilinear_slab", shape, torch.view_as_real(f),
                      torch.view_as_real(fp), 1e-4, GATHER_WHY),
              compare("insert_trilinear_slab", "T", t, tp, 1e-4, GATHER_WHY))
    del f, t, fp, tp
    npx = int(((vals != 0) | (c2w != 0)).sum())
    n_bytes = n_s * vals.shape[1] * 12 + n_s * 40 + bz * big * big * 12
    return record("insert_trilinear_slab", shape, err, timed(k, 3), plain_ms, n_bytes,
                  npx * mats.shape[0] * 63)


def phase_ranks(dev, wrappers):
    """Phase 8: ranks on the one card, sharing it over gloo.  8a the CLI
    on 1, 2 and 4 ranks (configs/demo.json resumed in local search on
    phase 7's data, ROUNDS_8 rounds): each rank loads only its rows, rank
    0's files are read back, each round's FSC-0.143 shell within
    SHELL_GATE_8 of the one-process run's.  8b a round's maps from the
    same data and injected draws on 4 ranks through the slab path against
    one process.  8c the slab path at a 320 px box's padded 640^3 grid
    (N_8C poses of the sharp C4 phantom) on 4 ranks against one process
    with whole grids (HK3, HK7).  HK9 against its twin at 8b's and 8c's
    shapes.  Returns (launches summed over every rank, HK9's records)."""
    import numpy as np
    import torch

    from thunder_tpu_torch import particle as pt
    from thunder_tpu_torch.cli import thunder
    from thunder_tpu_torch.config import ThunderConfig
    from thunder_tpu_torch.device import generator
    from thunder_tpu_torch.geometry.quaternion import random_quat, rotate3d
    from thunder_tpu_torch.geometry.symmetry import Symmetry
    from thunder_tpu_torch.io.thu import read_thu
    from thunder_tpu_torch.ops import insert
    from thunder_tpu_torch.ops.projector import prepare_projectee_3d, project_full_3d
    from thunder_tpu_torch.optimiser import RECO_COMPACT_SLOTS
    from thunder_tpu_torch.physics.ctf import ctf_params
    from thunder_tpu_torch.pipeline.synthetic import phantom
    from thunder_tpu_torch.constants import MIN_N_ITER_BALANCE
    from thunder_tpu_torch.recon.reconstructor import (_balance, finalize_reconstruction,
                                                       symmetrize_form, symmetrize_ft)

    launches = {n: 0 for n in wrappers}

    def add(ranks):
        for r in ranks:
            for n, c in r["launches"].items():
                launches[n] = launches.get(n, 0) + c

    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        cfg_path, _ = demo_160(tmp, dev, "demo.json", 1, ROUNDS_8, LOCAL_START_RES_A,
                               local_resume=True, snr=SNR_POST, n=N_POST)
        with open(cfg_path) as f:
            base = json.load(f)
        res, walls = {}, {}
        for world in RANKS_8:
            out = os.path.join(tmp, f"out_{world}")
            base["Basic"]["Path of Output"] = out + "/"
            cfg_w = os.path.join(tmp, f"demo_{world}.json")
            with open(cfg_w, "w") as f:
                json.dump(base, f)
            t0 = time.time()
            ranks = run_ranks("cli", dict(dir=tmp, tag=f"cli{world}", cfg=cfg_w), world)
            walls[world] = time.time() - t0
            add(ranks)
            _rank_lines(f"8a {world} ranks", ranks)
            want = N_POST // world if world > 1 else N_POST
            for r in ranks:
                if r["loaded"] != want:
                    fail(f"8a: rank {r['rank']} of {world} loaded {r['loaded']} images, not "
                         f"its {want} rows")
                idle = [n for n in PATH_KERNELS_8A if r["launches"][n] <= 0]
                if idle:
                    fail(f"8a: rank {r['rank']} of {world} never launched {idle}")
            check_maps(f"8a {world} ranks", out, ROUNDS_8, 1)
            if len(read_thu(os.path.join(out, f"Meta_Round_{ROUNDS_8 - 1:03d}.thu"))) != N_POST:
                fail(f"8a {world} ranks: the last .thu does not hold every image")
            with open(os.path.join(out, "round_metrics.jsonl")) as f:
                res[world] = [json.loads(line) for line in f]
            for rec in res[world]:
                say(f"  8a {world} ranks round {rec['round']}: res {rec['res_A']:.3f} A (shell "
                    f"{rec['res_shell']}), phases {rec['n_phases']}, {rec['elapsed_s']:.3f} s")
            say(f"  8a {world} ranks: wall {walls[world]:.1f} s (processes included)")
        for world in RANKS_8[1:]:
            for a, b in zip(res[world], res[1]):
                if abs(a["res_shell"] - b["res_shell"]) > SHELL_GATE_8:
                    fail(f"8a: {world} ranks' round {a['round']} crosses at shell "
                         f"{a['res_shell']}, one process at {b['res_shell']}")
        # do ranks repeat?  The 2-rank CLI once more from the same seed
        # into another directory: every output bit for bit
        base["Basic"]["Path of Output"] = os.path.join(tmp, "out_2_again") + "/"
        cfg_again = os.path.join(tmp, "demo_2_again.json")
        with open(cfg_again, "w") as f:
            json.dump(base, f)
        add(run_ranks("cli", dict(dir=tmp, tag="cli2_again", cfg=cfg_again), 2))
        same_runs("8a 2 ranks", os.path.join(tmp, "out_2"), os.path.join(tmp, "out_2_again"),
                  ROUNDS_8, lambda i: [f"Reference_000_{h}_Round_{i:03d}.mrc" for h in "AB"])

        # 8b: one process and 4 ranks from the same draws
        cfg = ThunderConfig.from_json(cfg_path)
        opt, _ = thunder.build_optimiser(cfg, dev)
        s = opt.state
        # the grading weights of a round: each image's score from its
        # resumed cloud (a round's phases set them before insertion)
        s.par = pt.cal_score(s.par, opt.mode)
        n_draw = min(cfg.m_reco, s.par.r.shape[2] * s.par.t.shape[2])
        draws = pt.draw_poses_compact(opt.gen, s.par, n_draw, min(n_draw, RECO_COMPACT_SLOTS))
        draws_path = os.path.join(tmp, "draws.npz")
        np.savez(draws_path, **{k: v.cpu().numpy() for k, v in
                                zip(("quats", "trans", "d", "w"), draws)})
        torch.cuda.synchronize()
        t0 = time.time()
        fsc1, map1, r_u = opt.reconstruct_maps(draws)
        torch.cuda.synchronize()
        one_ms = (time.time() - t0) * 1e3
        # the one-grid path against itself: a second call gives the same bits
        again = opt.reconstruct_maps(draws)
        same_bits("8b one-process maps", "FSC, maps", (fsc1, map1), again[:2])
        del again
        ranks = run_ranks("slab_round", dict(dir=tmp, tag="slab_round", cfg=cfg_path,
                                             draws=draws_path), 4)
        add(ranks)
        _rank_lines("8b", ranks)
        errs_b = []
        for h in (0, 1):
            got = np.load(os.path.join(tmp, f"slab_round_h{h}.npz"))
            errs_b += [_rel_l2(got["fsc"], fsc1[h].cpu().numpy()),
                       _rel_l2(got["map"], map1[h].cpu().numpy())]
        # 8b's 4 ranks once more: both hemispheres' maps bit for bit
        add(run_ranks("slab_round", dict(dir=tmp, tag="slab_round_again", cfg=cfg_path,
                                         draws=draws_path), 4))
        for h in (0, 1):
            a, b = (np.load(os.path.join(tmp, f"{tag}_h{h}.npz"))
                    for tag in ("slab_round", "slab_round_again"))
            if not all(np.array_equal(a[k].view(np.int32), b[k].view(np.int32))
                       for k in ("fsc", "map")):
                fail(f"8b: two runs of the slab path on 4 ranks differ (hemisphere {h})")
        say("  8b: a second run of the 4 ranks gave both hemispheres' maps bit for bit")
        big_b = ranks[0]["big"]
        say(f"  8b: r_u {r_u}, {big_b}^3 grids in slabs of {big_b // 2}; relative L2 of the "
            f"slab path's maps against one process (A fsc, A map, B fsc, B map): "
            f"{[f'{e:.3e}' for e in errs_b]}; "
            f"balance iterations a rank {[r['comm']['max_data']['calls'] for r in ranks]}; "
            f"one process {one_ms:.1f} ms, ranks {[round(r['ms'], 1) for r in ranks]} ms")
        if any(r["launches"]["insert_trilinear_slab"] < 1 or r["launches"]["insert_trilinear"]
               for r in ranks):
            fail("8b: a rank did not insert through HK9 alone")
        # HK9 at 8b's shape: hemisphere A's slices, the first slab
        w = (opt.valid_dev[0][:, None] * draws[3][0]).reshape(-1)
        sel = torch.nonzero(w > 0)[:, 0]
        n_slots = draws[3].shape[-1]
        vals, c2w, _, _ = insert.dense_slice_values(
            opt.data.ft_ori[0], opt.data.ctf_params.map(lambda a: a[0]), sel // n_slots,
            draws[1][0].reshape(-1, 2)[sel], w[sel], r_u, cfg.size, PIXEL_SIZE)
        rec_b = hk9_record("8b", dev, vals, c2w, rotate3d(draws[0][0].reshape(-1, 4)[sel]),
                           r_u, big_b, big_b // 2, opt.sym.matrices)
        del opt, draws, vals, c2w, fsc1, map1
        torch.cuda.empty_cache()

        # 8c: a 320 px box's padded grid
        rng = np.random.default_rng(8)
        vol = torch.as_tensor(phantom(SIZE_8C, rng, "sharp", "C4"), device=dev)
        quats = random_quat(generator(9, dev), (N_8C,), dev)
        rot = rotate3d(quats)
        table = prepare_projectee_3d(vol, 2)
        ft = torch.cat([project_full_3d(table, rot[i:i + 64]) for i in range(0, N_8C, 64)])
        del table, vol
        defocus = rng.uniform(8000, 20000, N_8C)
        cols = np.stack([np.full(N_8C, 300e3), defocus, defocus, np.zeros(N_8C),
                         np.full(N_8C, 2.7e7), np.full(N_8C, 0.1), np.zeros(N_8C)])
        paths = {k: os.path.join(tmp, f"8c_{k}.npy") for k in ("ft", "ctf", "quats")}
        np.save(paths["ft"], ft.cpu().numpy())
        np.save(paths["ctf"], cols)
        np.save(paths["quats"], quats.cpu().numpy())
        big = 2 * SIZE_8C
        mats = Symmetry("C4", dev).matrices
        form = symmetrize_form(mats)
        ctf = ctf_params(*cols, device=dev)
        bz_c = big // 2

        def one_grid(h):
            """Hemisphere h's (F, T) on one grid: HK3 then HK7."""
            ids = torch.arange(h, N_8C, 2, device=dev)
            f, t = insert.insert_trilinear(ft[ids].contiguous(), ctf.map(lambda a: a[ids]),
                                           torch.arange(ids.numel(), device=dev), rot[ids],
                                           torch.zeros(ids.numel(), 2, device=dev),
                                           torch.ones(ids.numel(), device=dev), R_U_8C, 2,
                                           SIZE_8C, PIXEL_SIZE, big)
            return symmetrize_ft(f, t, mats, float((R_U_8C - 1) * 2), form)

        def rec_8c(f, t, n_iter=None, each=None):
            """The MAP-free reconstruction of (F, T) and its balance loop's
            count, free-running or run for ``n_iter`` (each count's W to
            ``each``)."""
            t = t.real if t.is_complex() else t
            w, n = _balance(t, 2, R_U_8C, n_iter=n_iter, each=each)
            return finalize_reconstruction(f, w, SIZE_8C, 2, R_U_8C), int(n.max())

        # the one-grid path three times a hemisphere, which must give the
        # same bits; and its sensitivity to rounding: the maps of the same
        # (F, T) with each cell scaled by 1 + u 2^-23, u in {-1, 0, 1} drawn
        # from a seed (one float32 ulp or none a cell, as two orders of
        # summation differ), taken in the same call
        calls, t_one, sens, sens_maps, first_slab = [[], []], 0.0, [], [], None
        iters_one, iters_sens = [0, 0], [0, 0]
        gen_u = generator(10, dev)
        ulp = lambda x: x * (1 + torch.randint(-1, 2, x.shape, generator=gen_u, device=dev,
                                               dtype=torch.int8).to(x.dtype) * 2.0 ** -23)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for rep in range(3):
            for h in (0, 1):
                torch.cuda.synchronize()
                t0 = time.time()
                f, t = one_grid(h)
                vol, iters_one[h] = rec_8c(f, t)
                torch.cuda.synchronize()
                t_one += (time.time() - t0) if rep == 0 else 0.0
                if rep == 0:
                    if h == 0:
                        peak_one = torch.cuda.max_memory_allocated() / 1e9
                        first_slab = (f[:bz_c].clone(), t[:bz_c].clone())
                    f = torch.complex(ulp(f.real), ulp(f.imag))
                    t = ulp(t)
                    m, iters_sens[h] = rec_8c(f, t)
                    sens_maps.append(m.cpu().numpy())
                    sens.append(_rel_l2(sens_maps[-1], vol.cpu().numpy()))
                calls[h].append(vol.cpu().numpy())
                del f, t, vol
                torch.cuda.empty_cache()
        one = [c[0] for c in calls]
        if not all(np.array_equal(c[0].view(np.int32), c[i].view(np.int32))
                   for c in calls for i in (1, 2)):
            fail("8c: the one-grid path's maps differ between three calls on the same poses")
        # HK9 at 8c's shape: hemisphere A's 256 slices into the first slab
        ids = torch.arange(0, N_8C, 2, device=dev)
        vals, c2w, _, _ = insert.dense_slice_values(
            ft[ids], ctf.map(lambda a: a[ids]), torch.arange(ids.numel(), device=dev),
            torch.zeros(ids.numel(), 2, device=dev), torch.ones(ids.numel(), device=dev),
            R_U_8C, SIZE_8C, PIXEL_SIZE)
        f9, t9 = insert.insert_trilinear_slab(
            vals, c2w, rot[ids], torch.zeros(ids.numel(), dtype=torch.int32, device=dev),
            R_U_8C, 2, mats, 1, big, 0, bz_c)
        err_ft = [_rel_l2(torch.view_as_real(f9[0]).cpu().numpy(),
                          torch.view_as_real(first_slab[0]).cpu().numpy()),
                  _rel_l2(t9[0].cpu().numpy(), first_slab[1].cpu().numpy())]
        del f9, t9, first_slab
        rec_c = hk9_record("8c", dev, vals, c2w, rot[ids], R_U_8C, big, bz_c, mats)
        del vals, c2w
        torch.cuda.empty_cache()
        t0 = time.time()
        ranks = run_ranks("slab_big", dict(dir=tmp, tag="slab_big", n=N_8C, size=SIZE_8C,
                                           r_u=R_U_8C, **paths), 4)
        wall_c = time.time() - t0
        add(ranks)
        _rank_lines("8c", ranks)
        slab_maps = [np.load(os.path.join(tmp, f"slab_big_h{h}.npy")) for h in (0, 1)]
        errs = [_rel_l2(slab_maps[h], one[h]) for h in (0, 1)]
        # where the maps differ: inside insertion's band, Fourier shells below
        # r_u - 1, and in the ring up to the balance's r_u, where only spill
        # lands (ROADMAP Q3's band edge); each part's L2 over the whole map's
        split = [band_split(slab_maps[h], one[h], R_U_8C - 1) for h in (0, 1)]
        split_s = [band_split(sens_maps[h], one[h], R_U_8C - 1) for h in (0, 1)]
        # the balance loop's stop is a threshold, so the count moves with
        # rounding.  End to end: the one-grid maps at every count from 1 on
        # (the stopping rule off), their distance from the free-running
        # one-grid map; the counts that path can stop at are those from
        # MIN_N_ITER_BALANCE (below it only a converged loop stops) to the
        # largest it took, its own and with its cells scaled by an ulp, and
        # the slab path's free-running maps are held within
        # SPREAD_FACTOR_8C times the farthest of those maps.  In parts, at
        # the slabs' count: the slab path against the one-grid path and that
        # path's sensitivity to an ulp's scaling of its cells (printed), and
        # against the one-grid reconstruction of HK9's own (F, T), whose
        # change with its transforms composed as the slabs' bounds it
        iters_slab = [ranks[2 * h]["comm"]["max_data"]["calls"] for h in (0, 1)]
        forced, sens_forced, sens_fft, same_in, curves, spread = [], [], [], [], [], []
        windows = [(min(MIN_N_ITER_BALANCE, iters_one[h], iters_sens[h]),
                    max(iters_one[h], iters_sens[h])) for h in (0, 1)]
        gen_u = generator(11, dev)
        for h in (0, 1):
            f, t = one_grid(h)
            ref = torch.as_tensor(one[h], device=dev)
            curve, kept = {}, {}

            def each(n, w):
                m = finalize_reconstruction(f, w, SIZE_8C, 2, R_U_8C)
                curve[n] = float(torch.linalg.vector_norm(m - ref)
                                 / torch.linalg.vector_norm(ref))
                if n == iters_slab[h]:
                    kept[n] = m.cpu().numpy()

            rec_8c(f, t, max(windows[h][1], iters_slab[h]), each)
            curves.append(curve)
            spread.append(max(curve[n] for n in range(windows[h][0], windows[h][1] + 1)))
            at = kept[iters_slab[h]]
            forced.append(_rel_l2(slab_maps[h], at))
            f, t = torch.complex(ulp(f.real), ulp(f.imag)), ulp(t)
            sens_forced.append(_rel_l2(rec_8c(f, t, iters_slab[h])[0].cpu().numpy(), at))
            del f, t, ref
            # the slabs' own (F, T): HK9 with C4's mates pose-side over the
            # whole grid (a cell's sum does not depend on the slab's bounds),
            # reconstructed on one grid at the slabs' count
            ids = torch.arange(h, N_8C, 2, device=dev)
            vals, c2w, _, _ = insert.dense_slice_values(
                ft[ids], ctf.map(lambda a: a[ids]), torch.arange(ids.numel(), device=dev),
                torch.zeros(ids.numel(), 2, device=dev), torch.ones(ids.numel(), device=dev),
                R_U_8C, SIZE_8C, PIXEL_SIZE)
            f, t = insert.insert_trilinear_slab(
                vals, c2w, rot[ids], torch.zeros(ids.numel(), dtype=torch.int32, device=dev),
                R_U_8C, 2, mats, 1, big, 0, big)
            del vals, c2w
            at = rec_8c(f[0], t[0], iters_slab[h])[0].cpu().numpy()
            same_in.append(_rel_l2(slab_maps[h], at))
            with separable_fft():
                sens_fft.append(_rel_l2(rec_8c(f[0], t[0], iters_slab[h])[0].cpu().numpy(),
                                        at))
            del f, t
            torch.cuda.empty_cache()
        del ft
        say(f"  8c: balance iterations, one grid {iters_one}, one grid with its cells scaled "
            f"{iters_sens}, slabs {iters_slab}; at the slabs' count, the slab path against the "
            f"one-grid path (A, B) {['%.3e' % e for e in forced]}, which moves by "
            f"{['%.3e' % e for e in sens_forced]} under an ulp's scaling of its cells; against "
            f"the one-grid reconstruction of HK9's own (F, T) {['%.3e' % e for e in same_in]}, "
            f"which moves by {['%.3e' % e for e in sens_fft]} with its transforms composed "
            "as the slabs'")
        say(f"  8c: the slab path's difference from one process, (inside the band, the ring) "
            f"A {['%.3e' % e for e in split[0]]}, B {['%.3e' % e for e in split[1]]}; "
            f"an ulp's scaling of the one-grid cells, A {['%.3e' % e for e in split_s[0]]}, "
            f"B {['%.3e' % e for e in split_s[1]]}")
        iters = [r["comm"]["max_data"]["calls"] for r in ranks]
        moved = [r["comm"].get("all_to_all_z", {}).get("bytes", 0) for r in ranks]
        say(f"  8c: {SIZE_8C} px box, {big}^3 grids, slabs {ranks[0]['slab']}, {N_8C} poses, C4, "
            f"r_u {R_U_8C}: HK9's first slab of A against HK3 then HK7 (F, T) "
            f"{[f'{e:.3e}' for e in err_ft]}; the maps' relative L2 against one process (A, B) "
            f"{[f'{e:.3e}' for e in errs]}, one process identical in three calls, its maps "
            f"moved by {[f'{e:.3e}' for e in sens]} (A, B) by an ulp's scaling of its grids' "
            f"cells; balance iterations a rank {iters}; "
            f"one process {t_one:.2f} s (peak {peak_one:.2f} GB; 16.7 GB on an NVIDIA H100 80GB "
            f"HBM3 with the atomic form's scratch grid), ranks insert "
            f"{[round(r['insert_s'], 2) for r in ranks]} s and all "
            f"{[round(r['total_s'], 2) for r in ranks]} s (wall {wall_c:.1f} s with the "
            f"processes' start), peak {[round(r['peak_gb'], 2) for r in ranks]} GB, "
            f"transpose bytes a rank {moved}")
        for h in (0, 1):
            say(f"  8c: hemisphere {h}'s one-grid maps by balance count against its "
                f"free-running map ({iters_one[h]} iterations): "
                + " ".join(f"{n}:{e:.3e}" for n, e in sorted(curves[h].items()))
                + f"; stop counts {windows[h][0]}-{windows[h][1]}, farthest {spread[h]:.3e}; "
                f"the slab path's free-running map ({iters_slab[h]} iterations) "
                f"{errs[h]:.3e} from it")
        if max(errs_b) > SLAB_TOL:
            fail(f"8b: the slab path's maps differ from one process's by {max(errs_b):.3e} > "
                 f"{SLAB_TOL:g}")
        if max(err_ft) > SLAB_TOL:
            fail(f"8c: HK9's slab differs from HK3 then HK7 by {max(err_ft):.3e} > {SLAB_TOL:g}")
        for h, (e, sp) in enumerate(zip(same_in, sens_fft)):
            if e > max(SLAB_TOL, SPREAD_FACTOR_8C * sp):
                fail(f"8c: hemisphere {h}'s slab-path map differs from the one-grid "
                     f"reconstruction of the same (F, T) at {iters_slab[h]} balance iterations "
                     f"by {e:.3e}, more than {SLAB_TOL:g} and {SPREAD_FACTOR_8C} times that "
                     f"reconstruction's change with its transforms composed as the slabs' "
                     f"{sp:.3e}")
        for h in (0, 1):
            if iters_slab[h] < windows[h][0]:
                fail(f"8c: hemisphere {h}'s slab path stopped its balance loop after "
                     f"{iters_slab[h]} iterations, before any count the one-grid path stops "
                     f"at ({windows[h][0]}-{windows[h][1]})")
            if errs[h] > max(SLAB_TOL, SPREAD_FACTOR_8C * spread[h]):
                fail(f"8c: hemisphere {h}'s slab-path map differs from the one-grid path's by "
                     f"{errs[h]:.3e}, more than {SLAB_TOL:g} and {SPREAD_FACTOR_8C} times the "
                     f"farthest one-grid map at the counts that path stops at, "
                     f"{windows[h][0]}-{windows[h][1]} ({spread[h]:.3e})")
    hk9 = [r["launches"]["insert_trilinear_slab"] for r in ranks]
    if min(hk9) < 1:
        fail(f"8c: HK9 launches by rank {hk9}")
    return launches, dict(rec_c, shape_8b=rec_b, max_abs_err=max(rec_b["max_abs_err"],
                                                                 rec_c["max_abs_err"]))


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from thunder_tpu_torch import _native
        from thunder_tpu_torch.ops import gather
        from thunder_tpu_torch.ops.insert import insert_bilinear_2d, insert_mkb, insert_trilinear
        from thunder_tpu_torch.ops.likelihood import likelihood_block, likelihood_local_ctf
        from thunder_tpu_torch.ops.projector import project_slices, project_slices_2d
        from thunder_tpu_torch.physics.spectrum import shell_sums
        from thunder_tpu_torch.recon.reconstructor import symmetrize_ft
    except ImportError as e:
        fail(f"thunder_tpu_torch not importable ({e}); run from a checkout of the repo")

    dev = torch.device("cuda:0")
    t_start = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = (smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip()
            else f"nvidia-smi unavailable: {smi.stderr.strip()}")
    say(card)
    say(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.time()
    lib_path = _native.build()
    say(f"phase 0: kernels built in {time.time() - t0:.1f} s -> {os.path.relpath(lib_path, here)}")
    with open(os.path.join(_native.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                say("  ptxas: " + line.strip())
    _native.library()
    from thunder_tpu_torch.micro.launch_floor import empty_launch_ms

    floor_ms = empty_launch_ms()
    say(f"  an empty kernel, launched the same way and replayed as a CUDA graph: "
        f"{floor_ms:.4f} ms a launch (the floor under every kernel_alone_ms below)")

    say(f"[{time.time() - t_start:.1f} s] phase 1: 3D kernels against their plain versions")
    results = phase_kernels(dev)
    torch.cuda.synchronize()
    say(f"[{time.time() - t_start:.1f} s] phase 1b: 2D kernels against their plain versions")
    results_2d = phase_kernels_2d(dev)
    torch.cuda.synchronize()
    say(f"[{time.time() - t_start:.1f} s] phase 1c: HK7, HK8 and the K = 4 shapes against "
        "their plain versions")
    results_r = phase_kernels_refine(dev)
    torch.cuda.synchronize()

    wrappers = {"project_slices": project_slices, "likelihood_block": likelihood_block,
                "insert_trilinear": insert_trilinear, "shell_sums": shell_sums}
    say(f"[{time.time() - t_start:.1f} s] phase 2: 3D refinement")
    launches, _, prof_3d = phase_slice(dev, wrappers)
    torch.cuda.synchronize()

    say(f"[{time.time() - t_start:.1f} s] phase 3: gather microbenchmark (G1-G5, exact against plain)")
    g_recs, g_launches = phase_gather(dev, gather.KERNELS)
    zero = [n for n, c in g_launches.items() if c <= 0]
    if zero:
        fail(f"gather kernels never launched by the microbenchmark: {zero}")

    wrappers_2d = {"project_slices_2d": project_slices_2d,
                   "insert_bilinear_2d": insert_bilinear_2d,
                   "likelihood_block": likelihood_block, "shell_sums": shell_sums}
    say(f"[{time.time() - t_start:.1f} s] phase 4: 2D classification")
    launches_2d, _, prof_2d = phase_slice_2d(dev, wrappers_2d)
    torch.cuda.synchronize()

    wrappers_r = dict(wrappers, symmetrize_ft=symmetrize_ft,
                      likelihood_local_ctf=likelihood_local_ctf)
    say(f"[{time.time() - t_start:.1f} s] phase 5a: refinement as shipped (configs/demo.json)")
    launches_a, prof_a = phase_refine_a(dev, wrappers_r)
    say(f"[{time.time() - t_start:.1f} s] phase 5b: the same, resumed in local search")
    launches_b, prof_b = phase_refine_b(dev, wrappers_r)
    say(f"[{time.time() - t_start:.1f} s] phase 5c: the same resumed run with the MKB "
        "insertion option (reco_kernel mkb, HK10)")
    launches_mkb = phase_refine_mkb(dev, dict(wrappers_r, insert_mkb=insert_mkb))
    say(f"[{time.time() - t_start:.1f} s] phase 6: 3D classification (configs/demo_3D.json)")
    launches_k4, prof_k4 = phase_classify_3d(dev, wrappers_r)
    torch.cuda.synchronize()
    say(f"[{time.time() - t_start:.1f} s] phase 7: the post-refinement paths (genmask, "
        "subtraction, reconstruct, postprocess, project, tools, STAR)")
    launches_post, results_post, walls_post = phase_post(dev, wrappers_r)
    torch.cuda.synchronize()
    say(f"[{time.time() - t_start:.1f} s] phase 8: ranks sharing the card over gloo (the CLI "
        "on 1, 2 and 4 ranks; the slab path, HK9, at the demo's grid and at a 320 px box's)")
    launches_ranks, rec_hk9 = phase_ranks(dev, kernel_wrappers())
    torch.cuda.synchronize()
    say(f"[{time.time() - t_start:.1f} s] phase 9: whole runs against thunder_tpu's records "
        f"(run_parity cases {', '.join(PARITY_CASES)})")
    launches_parity = phase_parity(dev, kernel_wrappers())
    torch.cuda.synchronize()
    profiles = [prof_3d, prof_2d, prof_a, prof_b, prof_k4]
    later = dict(refine_a=launches_a, refine_b=launches_b, refine_mkb=launches_mkb,
                 classify_3d=launches_k4, post=launches_post, ranks=launches_ranks,
                 parity=launches_parity)
    for name in ("symmetrize_ft", "likelihood_local_ctf"):
        if sum(path.get(name, 0) for path in later.values()) <= 0:
            fail(f"{name} was never launched by phases 5 and 6")

    meta = {
        "project_slices": ("HK1", "thunder_tpu_torch/csrc/project_slices.cu",
                           "thunder_tpu/ops/projector.py:478"),
        "likelihood_block": ("HK2", "thunder_tpu_torch/csrc/likelihood_block.cu",
                             "thunder_tpu/optimiser.py:275"),
        "insert_trilinear": ("HK3", "thunder_tpu_torch/csrc/insert_trilinear.cu",
                             "thunder_tpu/optimiser.py:1400"),
        "shell_sums": ("HK4", "thunder_tpu_torch/csrc/shell_sums.cu",
                       "thunder_tpu/optimiser.py:379"),
        "project_slices_2d": ("HK5", "thunder_tpu_torch/csrc/project_slices_2d.cu",
                              "thunder_tpu/ops/projector.py:372"),
        "insert_bilinear_2d": ("HK6", "thunder_tpu_torch/csrc/insert_bilinear_2d.cu",
                               "thunder_tpu/ops/insert.py:721"),
        "symmetrize_ft": ("HK7", "thunder_tpu_torch/csrc/symmetrize_ft.cu",
                          "thunder_tpu/recon/reconstructor.py:309"),
        "likelihood_local_ctf": ("HK8", "thunder_tpu_torch/csrc/likelihood_local_ctf.cu",
                                 "thunder_tpu/ops/likelihood.py:100"),
        "insert_trilinear_slab": ("HK9", "thunder_tpu_torch/csrc/insert_trilinear.cu",
                                  "thunder_tpu/recon/sharded.py:300"),
        "insert_mkb": ("HK10", "thunder_tpu_torch/csrc/insert_trilinear.cu",
                       "thunder_tpu/ops/insert.py:76"),
    }
    # HK2's record is the 2D global block (the heaviest launch a round);
    # its other main-path blocks ride along.  HK4's is the hemisphere FSC
    # as spectrum.fsc launches it (the pair form); its other shapes ride
    # along by path and form
    hk4_shapes = {f"{path} {k}": r for path, recs_4 in (("3d", results["shell_sums"]),
                                                        ("2d", results_2d["shell_sums_2d"]))
                  for k, r in recs_4.items()}
    hk4_shapes["post full"] = results_post["shell_sums"]
    more_lk = results["likelihood_block_3d"] + results_2d["likelihood_block_more"]
    recs = {
        "project_slices": dict(
            results["project_slices"], k4_tables=results_r["project_slices_k4"],
            subtract_shape=results_post["project_slices"],
            max_abs_err=max(results["project_slices"]["max_abs_err"],
                            results_post["project_slices"]["max_abs_err"])),
        "likelihood_block": dict(
            results_2d["likelihood_block"], other_shapes=more_lk,
            max_abs_err=max(r["max_abs_err"] for r in more_lk + [results_2d["likelihood_block"]])),
        "insert_trilinear": dict(
            results["insert_trilinear"], refine_shapes=results_r["insert_trilinear_refine"],
            reconstruct_shape=results_post["insert_trilinear"],
            max_abs_err=max(results["insert_trilinear"]["max_abs_err"],
                            results_r["insert_trilinear_d"],
                            results_post["insert_trilinear"]["max_abs_err"],
                            *(r["max_abs_err"] for r in results_r["insert_trilinear_refine"]))),
        "shell_sums": dict(results["shell_sums"]["pair"], shapes=hk4_shapes,
                           max_abs_err=max(r["max_abs_err"] for r in hk4_shapes.values())),
        "project_slices_2d": results_2d["project_slices_2d"],
        "insert_bilinear_2d": results_2d["insert_bilinear_2d"],
        "symmetrize_ft": results_r["symmetrize_ft"],
        "likelihood_local_ctf": results_r["likelihood_local_ctf"],
        "insert_trilinear_slab": rec_hk9,
        "insert_mkb": dict(results["insert_mkb"], ctf_round=results_r["insert_mkb_ctf"],
                           max_abs_err=max(results["insert_mkb"]["max_abs_err"],
                                           results_r["insert_mkb_ctf"]["max_abs_err"])),
    }
    # the projection kernels' launches by caller: global search, the
    # phase loop, and the rest (the sigma / norm stage's rank-1 pass)
    split = {"project_slices": (launches, prof_3d), "project_slices_2d": (launches_2d, prof_2d)}
    kernels = []
    for name, r in recs.items():
        by_path = {"3d": launches.get(name, 0), "2d": launches_2d.get(name, 0)}
        by_path.update({path: counts.get(name, 0) for path, counts in later.items()})
        if name == "insert_mkb":
            # the option's main path is phase 5c's run
            by_path = {"refine_mkb": launches_mkb["insert_mkb"]}
        if name in split:
            n, by = split[name][0][name], split[name][1]["project_launches"]
            r = dict(r, launches_by_caller=dict(by, sigma=n - by["global"] - by["phase"]))
        if name == "shell_sums":
            r = dict(r, launches_by_caller={"3d": prof_3d["shell_sums_launches"],
                                            "2d": prof_2d["shell_sums_launches"]})
        kernels.append(dict(
            name=name, id=meta[name][0], route="cuda", source=meta[name][1],
            replaces=meta[name][2], launches=sum(by_path.values()), launches_by_path=by_path,
            **r))
    for fn in gather.KERNELS:
        cases = [c for c in g_recs if c["fn"] == fn.__name__]
        first = cases[0]
        b_ms, by = bound(first["io_bytes"], 0)
        # the plain version is itself the one library call (torch.take,
        # index_select, gather): library_ms is its time
        kernels.append(dict(
            name=fn.__name__, id=first["kernel"], route="cuda",
            source="thunder_tpu_torch/csrc/gather.cu", replaces=first["replaces"],
            also_replaces=[c["replaces"] for c in cases[1:]],
            launches=g_launches[fn.__name__],
            max_abs_err=max(c["max_abs_err"] for c in cases), ms=first["ms"],
            plain_ms=first["plain_ms"], library_ms=first["plain_ms"], bound_ms=b_ms,
            bound_by=by, share=b_ms / first["ms"], gbps=first["gbps"],
            alone_ms=first["alone_ms"],
            cases={c["case"]: dict(ms=c["ms"], plain_ms=c["plain_ms"], rate=c["rate"],
                                   unit=c["unit"], gbps=c["gbps"], alone_ms=c["alone_ms"],
                                   bound_ms=bound(c["io_bytes"], 0)[0]) for c in cases}))
    say(f"[{time.time() - t_start:.1f} s] done")
    say(card)
    say(json.dumps({"profiles": profiles}))
    say(json.dumps({"kernels": kernels, "empty_launch_ms": floor_ms,
                    "post_walls_s": walls_post}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        # one rank of phase 8 (started by run_ranks)
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        rank_entry(sys.argv[2], sys.argv[3], *map(int, sys.argv[4:7]))
    else:
        main()
