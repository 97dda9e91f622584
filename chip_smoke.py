#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``stgx_torch``) on one GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``stgx_torch/csrc``, holds each
kernel against its plain PyTorch version at the main path's shapes (fp32
and bf16) and times kernel, plain version and the one-call PyTorch
yardstick where there is one; for the fused layer kernels, which no one
PyTorch call computes, the yardstick is the port's unfused kernels for the
same function at the same shapes. It then drives the main path: RT-ST-GCN₉ at
its PKU-MMD width (``configs/pku-mmd/as_is/rtstgcn.json``, random weights
from the config's seed) in its batch form, unfused and fused, and its
streaming cell through ``stgx_torch.bench.serving``; it checks from the
launch counters that the path ran every kernel, and holds every output
against the all-plain run on the card. Under LayerNorm it checks that the
streamed logits equal the batch form's.

The training path follows: synthetic PKU-MMD trials through the port's
``Trainer`` (forward, backward through the ``gcn_grads`` and
``rt_fused_bwd`` kernels and the forward kernels' backward launches, Adam),
unfused and fused, with the exact launches of each step, the first step's
gradients against the all-plain run in float64, and a falling CE; then
``stgx_torch.bench.train_throughput`` at 8 x 1024 frames in fp32 and bf16,
unfused and fused.

RT-ST-GCN at Gamma = 69 follows (``configs/pku-mmd/as_is/rtstgcn_69.json``,
the same model with 69 taps; every layer's halo is past the fused kernel's
limit): ``window_sum`` against its plain version at the 9 layers' shapes
and at ragged ones (the plain version's bits, device times and bounds into
the kernels line as ``g69_`` figures), the batch forward with the fused core
off and on (both launch gcn_core and window_sum only; logits against the
all-plain run), one unfused train step (its exact launches, peak memory,
first-step gradients against the all-plain run in float64), and
``train_throughput`` in fp32 and bf16 with window_sum's share of the
device time.

Shift-GCN follows, at its PKU-MMD width (``configs/pku-mmd/as_is/shiftgcn.json``,
W = 50, random weights from the config's seed): the ``temporal_shift``
kernel against its plain version at the seven shapes of its 20 launches per
forward, and its backward kernel (``temporal_shift_bwd``) against
``temporal_shift_vjp_plain`` at the same shapes; the offline forward of
1024 windows (exactly 20 launches, logits against the all-plain run); the
window streaming cell at B = 1 (20 launches a step, logits against the
all-plain cell; under LayerNorm the streamed logits of frame t equal the
offline logits of window t); the ``window`` ``Trainer`` on synthetic trials
cut into chunks of ``SG_SEGMENT`` windows (20 launches of the shift and 20
of its backward a chunk step, the first step's gradients against the
all-plain run in float64, a falling CE); and ``train_throughput`` for
Shift-GCN in fp32 and bf16. Peak device memory of the offline forward and
of a train step is printed.

CoST-GCN follows, at its PKU-MMD width (``configs/pku-mmd/ln/costgcn.json``,
Gamma = 9, and ``costgcn_69.json``, Gamma = 69 with dilation up to 4;
LayerNorm; random weights from the config's seed). Its graph conv runs
gcn_core and gcn_grads, its temporal conv one matrix product a tap (cuDNN
for bf16 without dilation, ``conv_route``), held against cuDNN's
``F.conv2d`` at its 9 layers' shapes and timed beside it. The batch form of
N_BATCH x L_BATCH frames (fp32 and bf16 at Gamma = 9, fp32 at 69: gcn_core
once a layer, logits against the all-plain run, in bf16 within twice the
bf16 all-plain run's distance from fp32, forward ms, peak memory and the
temporal convs' share of the device time); the serving cell through
``stgx_torch.bench.serving --model co-st-gcn`` (B = 1 and 64 at Gamma = 9,
B = 1 at 69; gcn_core once a layer a step), the streamed logits against the
batch form's, and the cell at B_PEAK_CO streams (peak memory, step time,
FIFO state); ``check_stream_drift`` of the bf16 cell against the fp32 one
for CoST-GCN9 and RT-ST-GCN9, held to the JAX test's bounds; the training
path (one first step at N_TRAIN x L_TRAIN frames at each Gamma, its
launches, peak memory and gradients against the all-plain run in float64,
then two epochs with a falling CE at Gamma = 9); and ``train_throughput
--model co-st-gcn`` in fp32 and bf16 with the temporal convs' share.

Then the entry points a user runs, at full width: ``python -m
stgx_torch.cli`` driven in this process (``stgx_torch.cli.main``, so that
the launch counters see it) on synthetic PKU-MMD trials. RT-ST-GCN₉ at its
canonical config trains two epochs (every artifact, finite losses, the
launches of every train step), resumes from ``epoch-0`` to the unbroken
run's ``final`` (parameters and Adam moments within ``TOL_RESUME``), tests
``final`` (the last epoch's top1_val, F1@k, edit and confusion counts
again) and benchmarks (its latency line), then trains one epoch under
``arch.rt_fused``; Gamma = 69 trains one epoch and tests; Shift-GCN trains
one epoch through the window kind, tests and benchmarks; CoST-GCN9 trains
two epochs, resumes, tests and benchmarks as RT-ST-GCN9 does, and CoST-GCN
at Gamma = 69 trains one epoch and tests. ``arch.remat`` trains one RT₉
step and one CoST-GCN9 step (dropout drawn from an explicit generator) and
one Shift-GCN chunk step with gradients against the stored steps' and peak
memory beside theirs. Last, the headline's functions
(``stgx_torch.bench.headline``) at ``HEADLINE_FRAMES`` frames: the CUDA
graph's logits against graph-free streaming, the result line, and the peak
device memory of the serving cell at B = ``B_PEAK`` and of one RT₉ train
step. Each phase prints its seconds.

The int8 cells follow (``stgx_torch.bench.quant``): the two int8 products
(``int8_gemm``, ``w8_gemm``) against their plain versions at every product
site of RT9's and CoST9's cells at three stream counts, CoST at Gamma = 69's
temporal-conv sites, ragged shapes and a strided FIFO view, in every form of
the left operand (int8 codes; fp32 and bf16 quantized inside the product,
bf16 where the tma route takes the shape; the temporal convs' FIFO taps over int8, fp32 and bf16 state) and on the
route each shape takes (tma: wgmma fed by TMA; staged: mma.sync / FMAs),
int8 bit for bit, w8 within TOL_FP32, both repeatable, timed beside their
bounds, plain versions and yardsticks; the cells of RT9, CoST9, RT69 and
CoST69 in dynamic, static and w8 modes and fp32, bf16 and int8 state (one
product launch a site a step, no tap stack in CoST-GCN's cells, equal to the
cell on the plain versions, tracking the fp32 cell at the JAX tests' bounds;
the drift check with int8 state; int8 state a quarter of fp32's bytes); ``serving.py --quant int8-static --state-dtype ...``
beside the plain fp32 and bf16 cells at the same stream counts;
``quant_ab``; and the CLI's ``benchmark`` with ``processor.quantize``.

The window models follow, at the full width of their as_is configs
(``configs/pku-mmd/as_is/{stgcn,aagcn,mstcn,msgcn}.json``, W = 50, 52
classes): gcn_core and gcn_grads against their plain versions at ST-GCN's
shapes (R = windows x 50, 25 and 13 frames; C 64 -> 256) with their times
beside the bounds (``window_*`` keys of the kernels line); ST-GCN's batch
form of ST_WINDOWS windows in fp32 and bf16 (exactly 9 gcn_core, against
the all-plain run, windows/s, peak memory); its window cell through
``serving.py --model st-gcn``, plain and with ``--quant int8-static`` in
fp32 and bf16 state, and as a CUDA-graph replay; the int8 window
cell in dynamic, static and w8 modes with fp32 and bf16 state (equal to its
plain version, one product a site a step, tracking the fp32 cell, int8
state refused, graph replays); one train step each of ST-GCN and MS-GCN
(18 gcn_core and 9 gcn_grads), AA-GCN and MS-TCN (no kernel) with
first-step gradients against float64 (worst and median parameter, beside
the float64 step's own sensitivity to a 2^-24 perturbation) and peak
memory, AA-GCN's forward logits against float64 with its attention's
saturation, ST-GCN's falling
loss and ``train_throughput --model st-gcn``; and the CLI: ST-GCN trains,
resumes, tests and benchmarks with the int8 rows, MS-GCN, AA-GCN and MS-TCN
train and test.

Every phase that fails ends the run with a non-zero exit. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the card's name and power limit, and before that a ``kernels`` line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from unittest import mock

CONFIG = "configs/pku-mmd/as_is/rtstgcn.json"
CONFIG_69 = "configs/pku-mmd/as_is/rtstgcn_69.json"  # the same model at Gamma = 69
NUM_CLASSES = 52
N_BATCH, L_BATCH = 4, 1024  # batch form: captures x frames
N_TRAIN, L_TRAIN = 8, 1024  # train step: stacked trials x frames
# training path: synthetic PKU-MMD trials of 512-2048 frames, stacked 4 to a
# step in one 2048-frame bucket, one Adam step per 4 trials
TRAIN_TRIALS, TRAIN_LEN, TRAIN_BS, TRAIN_EPOCHS = 8, (512, 2048), 4, 3
B_STREAM, L_STREAM = 64, 256  # streaming check: streams x frames
SEED = 0

SG_CONFIG = "configs/pku-mmd/as_is/shiftgcn.json"
SG_WINDOWS = 1024  # offline forward: windows of one capture, one per frame
SG_STREAM = 256  # window streaming cell at B = 1: frames
SG_LN_FRAMES = 96  # LayerNorm streamed == offline: frames
# window Trainer: synthetic PKU-MMD trials of 300-700 frames in chunks of
# SG_SEGMENT windows (buckets of the same size), one Adam step per 2 trials
SG_TRIALS, SG_LEN, SG_BS, SG_EPOCHS, SG_SEGMENT = 4, (300, 700), 2, 3, 256
SG_THROUGHPUT_WINDOWS = 256  # train_throughput: windows a step
# the CLI phases: synthetic PKU-MMD trials (train, val) of CLI_LEN frames
CLI_TRIALS, CLI_LEN, CLI_BS = (4, 2), (300, 600), 2  # trials a step (Adam)
CLI_SG_TRIALS, CLI_SG_LEN = (2, 1), (200, 400)
REMAT_DROPOUT = 0.1  # dropout of the remat check's RT layers
HEADLINE_FRAMES = 4096  # frames a repeat of the headline's graph replay here
B_PEAK = 4096  # streams of the serving cell whose peak memory is read

CO_CONFIG = "configs/pku-mmd/ln/costgcn.json"  # CoST-GCN9, LayerNorm
CO_CONFIG_69 = "configs/pku-mmd/ln/costgcn_69.json"  # Gamma = 69, dilation to 4
CO_STREAM = 320  # streamed == batch: frames, past the deepest FIFO (273 at Gamma = 69)
B_PEAK_CO = {9: 1024, 69: 64}  # streams of the CoST-GCN serving cell, peak memory
# The window models at the full width of their as_is configs (52 classes,
# W = 50). ST-GCN's batch form: the ST_WINDOWS windows of one capture; its
# window cell through serving.py at ST_STREAM_B streams x ST_STREAM_FRAMES
# frames, the B = 1 cell also replayed from a CUDA graph over
# ST_GRAPH_FRAMES frames; AA-GCN's forward of AA_WINDOWS windows; the
# Trainer steps on synthetic trials of WIN_TRIAL frames (one chunk of
# WIN_TRIAL windows, the configs setting no segment), MS-TCN's on one
# trial of MT_TRIAL frames; WIN_EPOCHS epochs of WIN_TRIALS trials, an Adam
# step every WIN_BS, for the falling loss; the int8 window cell at
# ST_INT8_B streams x ST_INT8_L frames.
ST_CONFIG = "configs/pku-mmd/as_is/stgcn.json"
AA_CONFIG = "configs/pku-mmd/as_is/aagcn.json"
MT_CONFIG = "configs/pku-mmd/as_is/mstcn.json"
MG_CONFIG = "configs/pku-mmd/as_is/msgcn.json"
ST_WINDOWS, AA_WINDOWS = 1024, 256
ST_STREAM_B, ST_STREAM_FRAMES, ST_GRAPH_FRAMES = (1, 64), 64, 256
WIN_TRIAL, WIN_TRIALS, WIN_BS, WIN_EPOCHS, MT_TRIAL = 256, 4, 2, 2, 1024
ST_INT8_B, ST_INT8_L = 4, 64
WIN_INT8_RUNS = [(mode, sd) for mode in ("dynamic", "static", "w8")
                 for sd in ("float32", "bfloat16")]
CO_PEAK_FRAMES = 32  # frames streamed at B_PEAK_CO
DRIFT_FRAMES, DRIFT_B = 256, 4  # check_stream_drift: frames x streams
# CoST-GCN training: synthetic trials of CO_TRAIN_LEN frames in one L_TRAIN
# bucket, N_TRAIN stacked in the first step, CO_TRAIN_BS an Adam step after
CO_TRAIN_LEN, CO_TRAIN_BS, CO_EPOCHS = (768, 1024), 4, 2
SLEEP_CYCLES = 60_000_000  # device_ms: ~30 ms of a sleeping kernel, ahead of the host
# The int8 cells (stgx_torch.bench.quant). Kernel phase: every product site
# of RT9's cell at INT8_KERNEL_B[CONFIG] streams and of CoST9's at
# INT8_KERNEL_B[CO_CONFIG], CoST at Gamma = 69's temporal-conv sites at
# B_STREAM, and RAGGED_INT8 (M, K, N): M = 1, K = 3 with N = 52, K off the
# 64-byte tile with N off 8, K = 17,664 at M = 1. The kernels line sums one
# step of RT9's and of CoST9's cell at B_STREAM streams.
INT8_KERNEL_B = {CONFIG: (1, B_STREAM, 4096), CO_CONFIG: (1, B_STREAM, 1024)}
RAGGED_INT8 = [(1, 3, 52), (37, 40, 52), (1, 17664, 256), (130, 100, 300)]
# the large shapes the kernels line lists: RT9's layers 6-8 graph conv at
# B = 4096 and CoST69's deepest temporal conv at B = 64
LARGE_INT8 = [(102400, 768, 256), (1600, 17664, 256)]
QUANT_CHECK = 1 << 24  # values a scale of the quantize-vs-division check
# the cell phase: (config, tag); streams x frames; (mode, state type) runs
INT8_CONFIGS = [(CONFIG, "RT9"), (CO_CONFIG, "CoST9"), (CONFIG_69, "RT69"),
                (CO_CONFIG_69, "CoST69")]
INT8_CELL_B, INT8_CELL_L = 4, 256
INT8_RUNS = [("dynamic", "float32"), ("static", "float32"), ("static", "bfloat16"),
             ("static", "int8"), ("w8", "float32")]
# An int8 cell against the fp32 cell: mean relative distance below the JAX
# quant tests' 0.2 (0.15 for bf16 and int8 state against fp32 state), and
# top-1 agreement above tests/test_serving.py's 0.8 for the int8 cell
# against the fp32 one. The quant tests' own 0.9 was set on 5-class models
# of width 16; at 52 classes with random LayerNorm weights the logits' top-2
# margins are small, and CoST-GCN9's static cell agreed on 0.886 of its
# (frame, stream) pairs at a mean distance of 0.064 while equal, bit for
# bit, to the same cell on the plain versions (NVIDIA H100 80GB HBM3,
# 700 W; PERF.md, PR 9). The line prints whether 0.9 was met.
INT8_TOP1 = 0.8
# the serving phase: serving.py's streams by config, frames a probe
INT8_SERVE = {CONFIG: (1, B_STREAM, 1024), CO_CONFIG: (1, B_STREAM, 1024),
              CO_CONFIG_69: (1, B_STREAM)}
INT8_SERVE_FRAMES = 64
QUANT_AB_FRAMES, QUANT_AB_REPEATS = 512, 2  # quant_ab: frames replayed, repeats

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): fp32 on the
# CUDA cores, TF32 and bf16 on the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12, "int8": 1979e12}
# fp32 arithmetic that is not an FMA (an add, a product not fused into one):
# one instruction a lane, 128 lanes an SM, 132 SMs at 1.98 GHz; the FMA rate
# above counts two flops an instruction
PEAK_INSTR_S = 33.5e12
# Shapes off the main path for the graph-conv kernels, (R, V, P, C_in, C_out):
# C_in not a multiple of the copy width (3), C_out not one in bf16 (52, 300),
# C_out past one 256-wide tile, P = 4 (two partition groups), V = 7
RAGGED_GCN = [(1000, 25, 3, 3, 52), (1000, 25, 3, 200, 300), (37, 7, 4, 40, 24)]
# Shapes off the main path for window_sum, (N, L, V, C, Gamma, s): L shorter
# than the halo (40 < 68, 66), L not a multiple of the chunk, Q = V*C not a
# multiple of 4 (the scalar route), stride 2 with L odd, Gamma = 9 at V = 7,
# L = 5 and an odd C, and a halo (2099 frames) past what shared memory holds
RAGGED_WS = [(2, 40, 25, 64, 69, 1), (2, 40, 25, 64, 69, 2), (3, 1000, 25, 64, 69, 1),
             (2, 301, 25, 3, 69, 1), (2, 1023, 25, 128, 69, 2), (2, 45, 7, 52, 9, 1),
             (3, 5, 25, 64, 9, 1), (1, 777, 25, 13, 9, 2), (1, 3000, 25, 8, 2100, 1)]
# Shapes off the main path for the fused layer kernels, (N, L, V, P, C_in,
# C_out, Gamma, s): V = 7, P = 4, C_in = 3 with C_out = 52 and 300 (L = 45,
# not a multiple of any tile; stride 2); a sequence shorter than its halo
# (L = 5 < H = 8); the longest halos the dispatch rule admits (H = 64 at
# C = 64, H = 32 at C = 256)
RAGGED_RT = [(2, 45, 7, 4, 3, 52, 9, 1), (2, 45, 7, 4, 3, 300, 9, 2), (3, 5, 25, 3, 64, 64, 9, 1),
             (2, 200, 25, 3, 64, 64, 65, 1), (1, 100, 25, 3, 256, 256, 33, 1)]

# Tolerances, relative to max(1, max|plain|):
# kernel vs plain, an fp32 output: the same fp32 products summed in another
#   order, over up to P*V*C_in = 19,200 terms (bf16 inputs too: both sides
#   take the same bf16 values and sum them in fp32);
# kernel vs plain, a bf16 output: both sum in fp32, one rounding of the
#   output to bf16 (2^-8 relative) plus the order;
# whole model: nine normalised layers of fp32 sums in another order.
TOL_FP32, TOL_BF16, TOL_MODEL = 1e-4, 1e-2, 1e-4
# first-step parameter gradients, relative to max|ref| of each parameter.
# TOL_GRAD holds the fp32 kernel runs against the all-plain run in float64.
# The gradients of a layer's graph-conv weight and bias are sums over
# N*L*V = 204,800 terms that largely cancel after BatchNorm, so any fp32 run
# sits some way from the exact value: on the card the kernel runs are
# 2.0e-4 from it at worst (layers.7.gcn.bias) and the fp32 all-plain run
# 6.9e-4 (layers.7.gcn.kernel). Beside it, each parameter's kernel error
# must stay within GRAD_VS_PLAIN times the fp32 all-plain run's own error
# (plus TOL_FORMS): the kernels are never the less accurate side. TOL_FORMS
# holds the fused and the unfused kernel runs against each other. At
# Gamma = 69 the fp32 all-plain run is 4.55e-4 from float64 and the kernel
# run 4.57e-4 (layers.7.gcn.kernel), inside TOL_GRAD, which holds both.
TOL_GRAD, TOL_FORMS, GRAD_VS_PLAIN = 5e-4, 1e-5, 2.0
# Shift-GCN's first-step gradients against float64. Any fp32 run sits far
# from the exact value here: on the card the kernel run and the fp32
# all-plain run are both 6.84e-3 from it at worst (units.8.temporal
# .linear_kernel) and 1.7e-6 from each other, the kernels' only difference
# being the temporal shift's forward (the same bits as its plain version in
# fp32) and its closed-form backward. TOL_GRAD_SG is about twice that
# reading; the per-parameter GRAD_VS_PLAIN check is the one that would
# catch a kernel. The gradients that are zero in exact arithmetic (biases
# feeding a batch norm) are held to TOL_GRAD of the model's largest.
TOL_GRAD_SG = 1.5e-2
# CoST-GCN's first-step gradients against float64, by Gamma: GRAD_VS_PLAIN
# times the fp32 all-plain run's worst error, plus TOL_FORMS. On the card
# (NVIDIA H100 80GB HBM3, 700 W; PERF.md, run AV2) the all-plain run is
# 5.127e-4 from float64 at Gamma = 9 (layers.0.gcn.kernel) and 8.463e-4 at
# Gamma = 69 (layers.8.norm.bias), the kernel run 5.315e-4 and 3.947e-4; the
# run's own bound (GRAD_VS_PLAIN x its all-plain error + TOL_FORMS) is
# checked too. CoST-GCN gets no per-parameter check: two all-plain runs that
# differ only in the graph conv's order of sums (x.A first, or W first:
# gcn_core_channels_first) are each several times further than the other
# from float64 on single parameters, as the kernel run is; the training
# phase prints how many parameters each run would fail such a check on.
TOL_GRAD_CO = {9: 1.04e-3, 69: 1.70e-3}
# The window models' first-step gradients against float64, by family, set
# from their first runs on the card (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
# runs DA1, DA2). No fp32 run of an ST-GCN step of 256 windows is within
# 1e-3 of float64: the kernel run was 1.067e-3 from it at worst
# (layers.2.tcn_norm.bias), the fp32 all-plain run 1.923e-3
# (layers.6.norm.bias), so CoST-GCN's 1.04e-3 failed; MS-GCN, whose
# generator is the same ST-GCN, read 1.082e-3 and 1.922e-3. Their bound is
# about twice the kernel run's reading, above the all-plain run's. AA-GCN
# and MS-TCN launch no kernel: their runs equal the fp32 all-plain runs bit
# for bit (checked), 8.965e-2 (AA-GCN, joint_stream.norm_in.scale) and
# 4.830e-7 (MS-TCN) from float64; their bounds are twice those readings.
# AA-GCN's reading is the function's own conditioning, not fp32's sums: the
# float64 step itself moves 6.102e-2 on that leaf (5.660e-3 at the median
# leaf) when its weights and input are scaled by 1 +- 2^-24, fp32's unit
# roundoff, and 25-79 % of its attention rows are saturated (run DD). The
# run's own bound (GRAD_VS_PLAIN times the fp32 all-plain run's worst, plus
# TOL_FORMS) is checked beside. The median parameter's error is held too,
# at twice run DD's reading (kernels 2.859e-4 ST-GCN, 3.766e-7 MS-GCN,
# whose median falls among its refinement stages, 1.042e-2 AA-GCN, 1.315e-7
# MS-TCN; the fp32 all-plain runs 3.639e-4, 3.767e-7, 1.045e-2, 1.318e-7),
# and AA-GCN's forward logits of AA_WINDOWS windows at twice their reading
# from float64 (3.406e-5, DD).
TOL_GRAD_WIN = {"st-gcn": 2.2e-3, "ms-gcn": 2.2e-3, "aa-gcn": 0.18, "ms-tcn": 1e-6}
TOL_GRAD_WIN_MEDIAN = {"st-gcn": 6e-4, "ms-gcn": 8e-7, "aa-gcn": 2.1e-2, "ms-tcn": 2.7e-7}
TOL_AA_FORWARD = 7e-5
# a CLI run resumed from epoch-0 against the unbroken run (parameters and
# Adam moments, relative to max(1, max|ref|)); the CUDA graph's logits
# against graph-free streaming (cuBLAS may pick another algorithm under
# capture)
TOL_RESUME, TOL_GRAPH = 1e-5, 1e-5


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def rel_err(got, ref) -> tuple[float, float]:
    """(max abs error, that error over max(1, max|ref|))."""
    err = (got.float() - ref.float()).abs().max().item()
    return err, err / max(1.0, ref.float().abs().max().item())


def time_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Median over ``reps`` of one call, CUDA events around each call."""
    import torch

    for _ in range(warm):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(reps)]
    for s, e in zip(starts, ends):
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in zip(starts, ends))
    return times[len(times) // 2]


def device_ms(fn, calls: int = 10) -> float:
    """Device time of one call, for kernels that run shorter than their
    wrapper's host time (where ``time_ms`` reads the host): a sleeping kernel
    holds the stream while the host queues ``calls`` calls behind it, CUDA
    events around those calls; the median of three such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        torch.cuda._sleep(SLEEP_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / calls)
    return sorted(runs)[1]


@contextmanager
def plain_ops():
    """Send the model's kernel calls to their plain PyTorch versions, for the
    all-plain reference run on the card. The plain versions are einsums and
    shifted adds that autograd differentiates itself, so a backward under
    this context runs no kernel either: the autograd Functions whose
    backwards launch gcn_grads and rt_fused_bwd are never entered."""
    import stgx_torch.models.shiftgcn as sgm
    import stgx_torch.ops.gcn_core as gcm
    import stgx_torch.ops.graph_conv as gconv
    import stgx_torch.ops.rt_fused as rtf
    import stgx_torch.ops.shift as shm
    import stgx_torch.ops.temporal as temporal
    import stgx_torch.ops.window_sum as wsm

    with mock.patch.object(gconv, "gcn_core", gcm.gcn_core_plain), \
            mock.patch.object(temporal, "window_sum", wsm.window_sum_plain), \
            mock.patch.object(rtf, "rt_fused_core", rtf.rt_fused_plain), \
            mock.patch.object(sgm, "temporal_shift", shm.temporal_shift_plain):
        yield


def _wrappers():
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.gcn_grads import gcn_grads
    from stgx_torch.ops.rt_fused import rt_fused_bwd, rt_fused_core
    from stgx_torch.ops.shift import temporal_shift, temporal_shift_bwd
    from stgx_torch.ops.window_sum import window_sum

    return {"gcn_core": gcn_core, "window_sum": window_sum, "rt_fused": rt_fused_core,
            "gcn_grads": gcn_grads, "rt_fused_bwd": rt_fused_bwd,
            "temporal_shift": temporal_shift, "temporal_shift_bwd": temporal_shift_bwd}


def counts():
    return {name: fn.launches for name, fn in _wrappers().items()}


def reset_counts():
    for fn in _wrappers().values():
        fn.launches = 0


def _int8_wrappers():
    from stgx_torch.ops.int8_gemm import int8_gemm, w8_gemm

    return {"int8_gemm": int8_gemm, "w8_gemm": w8_gemm}


def all_counts():
    """The launch counts of every kernel, the int8 products' too."""
    return {**counts(), **{name: fn.launches for name, fn in _int8_wrappers().items()}}


ROUTES_SEEN = {}  # the int8 products' launches by route, summed over the resets


def reset_all_counts():
    reset_counts()
    for key, n in route_counts().items():
        ROUTES_SEEN[key] = ROUTES_SEEN.get(key, 0) + n
    for fn in _int8_wrappers().values():
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)


def phase_done(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def diff(after, before):
    return {k: after[k] - before[k] for k in after}


# ----------------------------------------------------------------- kernels


def bound(nbytes, flops, dtype="float32", instr=0):
    """(bound ms, bytes ms, operations ms) at the H100's peaks: ``flops`` of
    FMAs (or tensor-core products) at the type's peak, ``instr`` other fp32
    operations (adds, separate products) at PEAK_INSTR_S."""
    t_b = nbytes / PEAK_BYTES_S * 1e3
    t_o = (flops / PEAK_FLOPS[dtype] + instr / PEAK_INSTR_S) * 1e3
    return max(t_b, t_o), t_b, t_o


# the fp32 route of each tensor-core kernel: gcn_core's runs on the CUDA
# cores, gcn_grads' as three TF32 passes on the tensor cores
FP32_ROUTE = {"gcn_core": "FMA", "gcn_grads": "3 x TF32"}


def add_tensor_core_record(recs, name, shape, flops, b32, b16, ms16, lib16):
    """Print and add the tensor-core figures of gcn_core or gcn_grads: the
    bound of the kernel's fp32 route (the fp32 FMA bound ``b32``, or for
    three TF32 passes 3 x flops at the TF32 peak over the same bytes) and
    the bf16 kernel and einsum times beside the bf16 bound (``b16``: flops
    at the bf16 peak, the bf16 bytes)."""
    route = (b32[0] if FP32_ROUTE[name] == "FMA"
             else max(b32[1], 3 * flops / PEAK_FLOPS["tf32"] * 1e3))
    print(f"  {name} {shape}: bounds fp32 FMA {b32[0]:.4f} ms, fp32 route "
          f"({FP32_ROUTE[name]}) {route:.4f} ms; bfloat16: kernel {ms16:.4f} ms, "
          f"library {lib16:.4f} ms, bound {b16[0]:.4f} ms", flush=True)
    r = recs[name]
    for key, val in (("route_bound_ms", route), ("bf16_ms", ms16),
                     ("bf16_library_ms", lib16), ("bf16_bound_ms", b16[0])):
        r[key] = r.get(key, 0.0) + val


def add_fused_record(recs, name, shape, unfused_ms, ms16, unfused16, b16):
    """Print and add the yardstick of a fused kernel: the port's unfused
    kernels for the same function at the same shapes, in fp32 and bf16, and
    the bf16 kernel beside its bound (``b16``: flops at the bf16 peak, the
    bf16 bytes)."""
    print(f"  {name} {shape}: unfused kernels fp32 {unfused_ms:.4f} ms; bfloat16: kernel "
          f"{ms16:.4f} ms, unfused kernels {unfused16:.4f} ms, bound {b16[0]:.4f} ms",
          flush=True)
    r = recs[name]
    for key, val in (("unfused_ms", unfused_ms), ("bf16_ms", ms16),
                     ("bf16_unfused_ms", unfused16), ("bf16_bound_ms", b16[0])):
        r[key] = r.get(key, 0.0) + val


def add_record(recs, name, shape, err, ms, plain_ms, lib_ms, b):
    """Print one kernel timing and add it into ``recs[name]`` (the kernels
    line sums a kernel's records over the layers)."""
    lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
    print(f"  {name} {shape} float32: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"library {lib}, bound {b[0]:.4f} ms "
          f"({'bytes' if b[1] >= b[2] else 'operations'})", flush=True)
    r = recs.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                               "library_ms": 0.0 if lib_ms is not None else None,
                               "bound_ms": 0.0, "_tb": 0.0, "_to": 0.0})
    r["max_abs_err"] = max(r["max_abs_err"], err)
    r["ms"] += ms
    r["plain_ms"] += plain_ms
    if lib_ms is not None:
        r["library_ms"] += lib_ms
    r["bound_ms"] += b[0]
    r["_tb"] += b[1]
    r["_to"] += b[2]


def window_adds(n, l, q, k, s):
    """Adds of a window-sum of k taps s apart over (n, l, q): each output's
    taps inside the sequence, less one."""
    return n * q * sum(min(k, t // s + 1) - 1 for t in range(l))


def check_equal(name, got, ref):
    """The kernel gives the plain version's bits."""
    import torch

    torch.cuda.synchronize()
    check(bool(torch.isfinite(got.float()).all()), f"{name}: non-finite")
    check(torch.equal(got, ref), f"{name}: not the plain version's bits (max abs err "
          f"{rel_err(got, ref)[0]:.3e})")


def window_records(recs, prefix, shapes, gamma, rnd):
    """window_sum against its plain version at the 9 layers' shapes
    ``(N_BATCH, L_BATCH, 25, C_out)`` with ``gamma`` and each layer's stride,
    both directions, fp32 and bf16: the plain version's bits. Times are
    device times (``device_ms``) summed over the layers, into
    ``recs["window_sum"]`` under ``prefix`` (the Gamma = 9 record's own keys,
    or ``g69_`` ones): fp32 forward (``ms``) and reverse, bf16 both, the
    plain version, ``F.conv2d`` with a ones kernel (the library yardstick),
    and the bounds (bytes, or the adds at PEAK_INSTR_S)."""
    import torch
    import torch.nn.functional as F

    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    sums = {}

    def add(key, val):
        sums[key] = sums.get(key, 0.0) + val

    for cout, s in shapes:
        x32 = rnd(N_BATCH, L_BATCH, 25, cout)
        k = gamma // s
        shape = tuple(x32.shape) + (gamma, s)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for rev in (False, True):
                check_equal(f"window_sum {shape} {str(dt)[6:]}{' reverse' if rev else ''}",
                            window_sum(x, gamma, s, rev), window_sum_plain(x, gamma, s, rev))
                add(("bf16_" if dt == torch.bfloat16 else "") + ("reverse_ms" if rev else "ms"),
                    device_ms(lambda: window_sum(x, gamma, s, rev)))
        ones = torch.ones(1, 1, k, 1, device="cuda")
        x4 = x32.view(N_BATCH, 1, L_BATCH, 25 * cout)
        add("plain_ms", device_ms(lambda: window_sum_plain(x32, gamma, s), calls=3))
        if not prefix:  # the way earlier runs timed it: host time included
            add("wall_ms", time_ms(lambda: window_sum(x32, gamma, s)))
        add("library_ms", device_ms(lambda: F.conv2d(x4, ones, padding=((k - 1) * s, 0),
                                                     dilation=(s, 1))[:, :, :L_BATCH], calls=3))
        adds = window_adds(N_BATCH, L_BATCH, 25 * cout, k, s)
        b32, b16 = bound(8 * x32.numel(), 0, instr=adds), bound(4 * x32.numel(), 0, instr=adds)
        for key, val in (("bound_ms", b32[0]), ("_tb", b32[1]), ("_to", b32[2]),
                         ("bf16_bound_ms", b16[0])):
            add(key, val)
    by = "bytes" if sums["_tb"] >= sums["_to"] else "operations"
    print(f"  window_sum over the 9 layers at Gamma={gamma} (device time): float32 forward "
          f"{sums['ms']:.4f} ms, reverse {sums['reverse_ms']:.4f} ms, bound {sums['bound_ms']:.4f} "
          f"ms ({by}); bfloat16 forward {sums['bf16_ms']:.4f} ms, reverse "
          f"{sums['bf16_reverse_ms']:.4f} ms, bound {sums['bf16_bound_ms']:.4f} ms; plain "
          f"{sums['plain_ms']:.4f} ms, F.conv2d {sums['library_ms']:.4f} ms", flush=True)
    r = recs.setdefault("window_sum", {"max_abs_err": 0.0})
    for key, val in sums.items():
        if not key.startswith("_") or not prefix:
            r[prefix + key] = val
    if prefix:
        r[prefix + "bound_by"] = by


def compare(name, shape, kern, plain, dtype, tol):
    """Kernel against plain version on the same inputs; returns the max abs
    error (of the worst output where there are several). ``tol`` holds the
    outputs stored in the input's type; an fp32 output of bf16 inputs (the
    backward kernels' gradients) is held to TOL_FP32."""
    import torch

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    if isinstance(got, torch.Tensor):
        got, ref = (got,), (ref,)
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        if g is None and r is None:
            continue
        t = TOL_FP32 if g.dtype == torch.float32 else tol
        err, rel = rel_err(g, r)
        print(f"  {name} {shape} {dtype} output {i}: max abs err {err:.3e} "
              f"(relative {rel:.3e}, tolerance {t:g})", flush=True)
        check(bool(torch.isfinite(g.float()).all()), f"{name} {shape}: non-finite")
        check(rel <= t, f"{name} {shape} {dtype} output {i}: relative error "
              f"{rel:.3e} > {t}")
        worst = max(worst, err)
    return worst


def kernel_phase(model, layers):
    """Each forward kernel against its plain version at the main path's
    shapes. Returns the per-kernel records of the ``kernels`` line (without
    launches)."""
    import torch
    import torch.nn.functional as F

    from stgx_torch.ops.gcn_core import gcn_core, gcn_core_plain
    from stgx_torch.ops.rt_fused import rt_fused_core, rt_fused_plain
    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    v, p, gamma = model.num_joints, model.partitions, model.kernel
    A0 = model.A

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    recs = {}

    def add(*a):
        add_record(recs, *a)

    # gcn_core: R = N*L rows in the batch form, R = B streams in the cell
    print("gcn_core vs plain (csrc/gcn_core.cu)", flush=True)
    step_ms = {}
    for rows in (N_BATCH * L_BATCH, 1, B_STREAM):
        for cin, cout, _ in layers:
            A = (A0 * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
            W = rnd(p, cin, cout, scale=cin**-0.5)
            x32 = rnd(rows, v, cin)
            errs = {}
            for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
                x = x32.to(dt)
                errs[dt] = compare("gcn_core", (rows, v, cin, cout), lambda: gcn_core(x, A, W),
                                   lambda: gcn_core_plain(x, A, W), str(dt)[6:], tol)
            ms = time_ms(lambda: gcn_core(x32, A, W))
            if rows == N_BATCH * L_BATCH:
                plain_ms = time_ms(lambda: gcn_core_plain(x32, A, W))
                lib_ms = time_ms(lambda: torch.einsum("rvc,pvw,pcd->rwd", x32, A, W))
                flops = 2 * rows * v * p * cin * (v + cout)
                values = rows * v * (cin + cout) + p * v * v + p * cin * cout
                b32 = bound(4 * values, flops)
                add("gcn_core", (rows, v, cin, cout), errs[torch.float32], ms,
                    plain_ms, lib_ms, b32)
                xb, Ab, Wb = x32.bfloat16(), A.bfloat16(), W.bfloat16()
                add_tensor_core_record(
                    recs, "gcn_core", (rows, v, cin, cout), flops, b32,
                    bound(2 * values, flops, "bfloat16"), time_ms(lambda: gcn_core(xb, Ab, Wb)),
                    time_ms(lambda: torch.einsum("rvc,pvw,pcd->rwd", xb, Ab, Wb)))
            else:
                print(f"  gcn_core {(rows, v, cin, cout)} float32: kernel {ms:.4f} ms",
                      flush=True)
                step_ms[rows] = step_ms.get(rows, 0.0) + ms
    for rows, ms in step_ms.items():
        print(f"  gcn_core at R={rows}: {ms:.4f} ms per streaming step (9 launches)",
              flush=True)
    for rows, vr, pr, cin, cout in RAGGED_GCN:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32 = rnd(rows, vr, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            compare("gcn_core", (rows, vr, pr, cin, cout), lambda: gcn_core(x, A, W),
                    lambda: gcn_core_plain(x, A, W), str(dt)[6:], tol)

    print("window_sum vs plain (csrc/window_sum.cu)", flush=True)
    window_records(recs, "", [(cout, s) for _, cout, s in layers], gamma, rnd)

    print("rt_fused vs plain (csrc/rt_fused.cu)", flush=True)
    rows = N_BATCH * L_BATCH
    for cin, cout, s in layers:
        A = (A0 * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        beff = rnd(v, cout, scale=0.1)
        x32 = rnd(N_BATCH, L_BATCH, v, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            e = compare("rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s),
                        lambda: rt_fused_core(x, A, W, beff, gamma, s),
                        lambda: rt_fused_plain(x, A, W, beff, gamma, s), str(dt)[6:], tol)
            if dt == torch.float32:
                err = e
        ms = time_ms(lambda: rt_fused_core(x32, A, W, beff, gamma, s))
        plain_ms = time_ms(lambda: rt_fused_plain(x32, A, W, beff, gamma, s))
        flops = 2 * rows * v * p * cin * (v + cout)
        adds = window_adds(N_BATCH, L_BATCH, v * cout, gamma // s, s)
        values = rows * v * (cin + cout) + p * v * v + p * cin * cout + v * cout
        add("rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s), err, ms, plain_ms,
            None, bound(4 * values, flops, instr=adds))
        # the yardstick: the port's unfused kernels for the same function,
        # gcn_core then window_sum, and the bf16 kernel beside its bound
        xb, Ab, Wb = x32.bfloat16(), A.bfloat16(), W.bfloat16()
        add_fused_record(
            recs, "rt_fused", (N_BATCH, L_BATCH, v, cin, cout, gamma, s),
            time_ms(lambda: window_sum(gcn_core(x32.view(rows, v, cin), A, W).view(
                N_BATCH, L_BATCH, v, cout), gamma, s)),
            time_ms(lambda: rt_fused_core(xb, Ab, Wb, beff, gamma, s)),
            time_ms(lambda: window_sum(gcn_core(xb.view(rows, v, cin), Ab, Wb).view(
                N_BATCH, L_BATCH, v, cout), gamma, s)),
            bound(2 * values, flops, "bfloat16", instr=adds))
    for n_, l_, vr, pr, cin, cout, gamma_r, s in RAGGED_RT:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        beff = rnd(vr, cout, scale=0.1)
        x32 = rnd(n_, l_, vr, cin)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            compare("rt_fused", (n_, l_, vr, pr, cin, cout, gamma_r, s),
                    lambda: rt_fused_core(x, A, W, beff, gamma_r, s),
                    lambda: rt_fused_plain(x, A, W, beff, gamma_r, s), str(dt)[6:], tol)
    return recs


def check_repeatable(name, kern):
    """Two calls give the same bits: the cross-block sums run in a fixed
    order, with no atomics."""
    import torch

    a, b = kern(), kern()
    check(all(torch.equal(x, y) for x, y in zip(a, b)),
          f"{name}: two calls on the same inputs differ")


def print_split(name, dt, prof, parts):
    """The device time of a wrapper's kernels by name, summed over the 9
    layers (torch.profiler; a kernel's name, a template, ends in '<...>')."""
    split = {part: sum(t["ms"] for t in prof["top_kernels"] if f"::{part}<" in t["name"])
             for part in parts}
    print(f"  {name} split over the 9 layers, {dt}: "
          + ", ".join(f"{part} {ms:.4f} ms" for part, ms in split.items()), flush=True)


def backward_kernel_phase(model, layers):
    """The two backward kernels against their plain versions at the training
    path's shapes (N_TRAIN x L_TRAIN frames, each of the 9 layers), fp32 and
    bf16. Returns their records of the ``kernels`` line."""
    import torch

    from stgx_torch.bench.train_throughput import profile_steps
    from stgx_torch.ops.gcn_core import gcn_core
    from stgx_torch.ops.gcn_grads import gcn_grads, gcn_grads_plain
    from stgx_torch.ops.rt_fused import rt_fused_bwd, rt_fused_bwd_plain
    from stgx_torch.ops.window_sum import window_sum

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    v, p, gamma = model.num_joints, model.partitions, model.kernel
    n, l = N_TRAIN, L_TRAIN
    rows = n * l
    recs = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    print("gcn_grads vs plain (csrc/gcn_grads.cu)", flush=True)
    split_inputs = []
    for cin, cout, _ in layers:
        A = (model.A * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(rows, v, cin), rnd(rows, v, cout)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            errs[dt] = compare("gcn_grads", (rows, v, cin, cout), lambda: gcn_grads(x, g, A, W),
                               lambda: gcn_grads_plain(x, g, A, W), str(dt)[6:], tol)
            check_repeatable("gcn_grads", lambda: gcn_grads(x, g, A, W))
        ms = time_ms(lambda: gcn_grads(x32, g32, A, W))
        plain_ms = time_ms(lambda: gcn_grads_plain(x32, g32, A, W))
        # the yardstick: _core_bwd's two fp32 einsums (pallas_gcn.py:228-231)
        lib_ms = time_ms(lambda: (torch.einsum("rvc,pvw,rwd->pcd", x32, A, g32),
                                  torch.einsum("rvc,rwd,pcd->pvw", x32, g32, W)))
        flops = 4 * rows * p * v * cin * (v + cout)
        ins, outs = rows * v * (cin + cout) + p * v * v + p * cin * cout, p * v * v + p * cin * cout
        b32 = bound(4 * (ins + outs), flops)
        add_record(recs, "gcn_grads", (rows, v, cin, cout), errs[torch.float32], ms,
                   plain_ms, lib_ms, b32)
        xb, gb, Ab, Wb = x32.bfloat16(), g32.bfloat16(), A.bfloat16(), W.bfloat16()
        split_inputs.append(((x32, g32, A, W), (xb, gb, Ab, Wb)))
        add_tensor_core_record(
            recs, "gcn_grads", (rows, v, cin, cout), flops, b32,
            bound(2 * ins + 4 * outs, flops, "bfloat16"),
            time_ms(lambda: gcn_grads(xb, gb, Ab, Wb)),
            time_ms(lambda: (torch.einsum("rvc,pvw,rwd->pcd", xb, Ab, gb),
                             torch.einsum("rvc,rwd,pcd->pvw", xb, gb, Wb))))
    # the device time of gcn_grads' own kernels, summed over the 9 layers
    for k, dt in enumerate(("float32", "bfloat16")):
        prof = profile_steps(lambda: [gcn_grads(*inputs[k]) for inputs in split_inputs])
        print_split("gcn_grads", dt, prof, ("gw_kernel", "ga_kernel", "reduce_kernel"))
    del split_inputs
    for r_, vr, pr, cin, cout in RAGGED_GCN:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(r_, vr, cin), rnd(r_, vr, cout)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            compare("gcn_grads", (r_, vr, pr, cin, cout), lambda: gcn_grads(x, g, A, W),
                    lambda: gcn_grads_plain(x, g, A, W), str(dt)[6:], tol)
            check_repeatable("gcn_grads", lambda: gcn_grads(x, g, A, W))

    print("rt_fused_bwd vs plain (csrc/rt_fused_bwd.cu)", flush=True)
    split_inputs = []
    for cin, cout, s in layers:
        A = (model.A * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
        W = rnd(p, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(n, l, v, cin), rnd(n, l, v, cout)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            errs[dt] = compare("rt_fused_bwd", (n, l, v, cin, cout, gamma, s),
                               lambda: rt_fused_bwd(x, g, A, W, gamma, s),
                               lambda: rt_fused_bwd_plain(x, g, A, W, gamma, s),
                               str(dt)[6:], tol)
            check_repeatable("rt_fused_bwd", lambda: rt_fused_bwd(x, g, A, W, gamma, s))
        ms = time_ms(lambda: rt_fused_bwd(x32, g32, A, W, gamma, s))
        plain_ms = time_ms(lambda: rt_fused_bwd_plain(x32, g32, A, W, gamma, s))
        # (gx, gA, gW) at their least work; the window's adds and gbe's sum
        flops = 2 * rows * p * v * (2 * cin * cout + 3 * v * cin)
        adds = window_adds(n, l, v * cout, gamma // s, s) + rows * v * cout
        ins, outs = rows * v * (cin + cout) + p * v * v + p * cin * cout, (
            rows * v * cin, p * v * v + p * cin * cout + v * cout)
        add_record(recs, "rt_fused_bwd", (n, l, v, cin, cout, gamma, s), errs[torch.float32],
                   ms, plain_ms, None, bound(4 * (ins + sum(outs)), flops, instr=adds))

        # the yardstick: the port's unfused backward kernels for the same
        # function, window_sum reverse, gcn_core on (gy, A^T, W^T), gcn_grads
        def unfused(x, g, A, W):
            gy = window_sum(g, gamma, s, reverse=True).view(rows, v, cout)
            return (gcn_core(gy, A.transpose(1, 2).contiguous(), W.transpose(1, 2).contiguous()),
                    gcn_grads(x.view(rows, v, cin), gy, A, W))

        xb, gb, Ab, Wb = x32.bfloat16(), g32.bfloat16(), A.bfloat16(), W.bfloat16()
        split_inputs.append(((x32, g32, A, W, gamma, s), (xb, gb, Ab, Wb, gamma, s)))
        add_fused_record(
            recs, "rt_fused_bwd", (n, l, v, cin, cout, gamma, s),
            time_ms(lambda: unfused(x32, g32, A, W)),
            time_ms(lambda: rt_fused_bwd(xb, gb, Ab, Wb, gamma, s)),
            time_ms(lambda: unfused(xb, gb, Ab, Wb)),
            bound(2 * (ins + outs[0]) + 4 * outs[1], flops, "bfloat16", instr=adds))
    # the device time of rt_fused_bwd's own kernels, summed over the 9 layers
    for k, dt in enumerate(("float32", "bfloat16")):
        prof = profile_steps(lambda: [rt_fused_bwd(*inputs[k]) for inputs in split_inputs])
        print_split("rt_fused_bwd", dt, prof, ("window_kernel", "gw_kernel", "ga_kernel",
                                               "reduce_kernel"))
    del split_inputs
    for n_, l_, vr, pr, cin, cout, gamma_r, s in RAGGED_RT:
        A = torch.rand(pr, vr, vr, generator=gen, device="cuda")
        W = rnd(pr, cin, cout, scale=cin**-0.5)
        x32, g32 = rnd(n_, l_, vr, cin), rnd(n_, l_, vr, cout)
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g = x32.to(dt), g32.to(dt)
            compare("rt_fused_bwd", (n_, l_, vr, pr, cin, cout, gamma_r, s),
                    lambda: rt_fused_bwd(x, g, A, W, gamma_r, s),
                    lambda: rt_fused_bwd_plain(x, g, A, W, gamma_r, s), str(dt)[6:], tol)
            check_repeatable("rt_fused_bwd", lambda: rt_fused_bwd(x, g, A, W, gamma_r, s))
    return recs


def grad_err(got, ref) -> float:
    """Max abs error over max|ref|: each parameter's gradient at its own
    scale, however small."""
    err = (got.double() - ref.double()).abs().max().item()
    scale = ref.double().abs().max().item()
    return err / scale if scale > 0 else err


def worst_grad_err(got, ref):
    """(worst grad_err over the parameters, that parameter's name)."""
    return max((grad_err(got[k], ref[k]), k) for k in ref)


def first_step_grads(trainer, batch, divisors=None, generator=None):
    """The parameter gradients of one grad step on ``batch``, cleared after.
    ``divisors`` defaults to the batch size for each stacked trial; dropout
    draws from ``generator``."""
    trainer.optimizer.zero_grad(set_to_none=True)
    if divisors is None:
        divisors = [float(trainer.opt.batch_size)] * batch[0].shape[0]
    trainer.grad_step(*batch, divisors, generator)
    grads = {k: p.grad.detach().clone() for k, p in trainer.model.named_parameters()}
    trainer.optimizer.zero_grad(set_to_none=True)
    return grads


def float64_grads(trainer, batch):
    """The first step's parameter gradients in float64: a copy of the model
    and the batch in float64 through the all-plain unfused path (the plain
    versions sum in the input's type where it is wider than fp32), with the
    loss and divisors of ``first_step_grads``."""
    import copy

    import torch

    from stgx_torch.ops.rt_fused import rt_fused_enabled

    check(not rt_fused_enabled(), "the float64 witness runs the unfused form")
    model = copy.deepcopy(trainer.model).double()
    x, y, mask = batch
    with plain_ops():
        out = model(x.double(), mask=mask, train=True)
        ce, mse = trainer.loss(out, y, mask, per_sample=True)
        ((ce + mse) / float(trainer.opt.batch_size)).sum().backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    check(all(g.dtype == torch.float64 for g in grads.values()),
          "the float64 witness lost its precision")
    return grads


def training_phase(cfg, data_dir):
    """The training path at full width: synthetic PKU-MMD trials through the
    Trainer, unfused and fused. Checks the per-step launches, the first
    step's gradients against the all-plain run in float64 (the fp32
    all-plain run's own distance from it is printed beside) and a falling
    CE; returns the launch counts of the two paths."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.ops.rt_fused import set_rt_fused
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.segments import pad_to_bucket
    from stgx_torch.utils import LOSS

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=TRAIN_TRIALS, num_val=0, min_len=TRAIN_LEN[0],
             max_len=TRAIN_LEN[1], seed=SEED)
    ds = SkeletonDirDataset(os.path.join(data_dir, "train", "features"),
                            os.path.join(data_dir, "train", "labels"))
    dist = class_distribution(ds, NUM_CLASSES)
    n_layers = len(cfg["arch"]["rt-st-gcn"]["in_ch"])
    steps = -(-TRAIN_TRIALS // TRAIN_BS) * TRAIN_EPOCHS
    first = [pad_to_bucket(*ds[i], TRAIN_LEN[1]) for i in range(TRAIN_BS)]
    launched, kernel_grads, exact = {}, {}, None
    for fused in (False, True):
        name = "fused" if fused else "unfused"
        set_rt_fused(fused)
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["rt-st-gcn"](dist),
                          opt=OptimizerConfig(
                              learning_rate=cfg["optimizer"]["learning_rate"],
                              batch_size=TRAIN_BS, seed=SEED),
                          bucket=TRAIN_LEN[1], trial_batch=TRAIN_BS)
        batch = trainer.stack_trials(*zip(*first))
        before = counts()
        if exact is None:  # the same start and batch in both forms
            exact = float64_grads(trainer, batch)
        with plain_ops():
            ref = first_step_grads(trainer, batch)
        check(counts() == before, "the all-plain training steps launched a kernel")
        got = kernel_grads[name] = first_step_grads(trainer, batch)
        check(all(bool(torch.isfinite(g).all()) for g in got.values()),
              f"train {name}: non-finite gradients")
        worst = worst_grad_err(got, exact)
        plain32 = worst_grad_err(ref, exact)
        print(f"train {name}: first-step gradients vs all-plain float64, worst relative "
              f"error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD:g}); the fp32 "
              f"all-plain run's {plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 "
              f"all-plain {worst_grad_err(got, ref)[0]:.3e}", flush=True)
        errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                       for k in exact), reverse=True)
        for e_k, e_p, k in errs[:5]:
            print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64",
                  flush=True)
        check(worst[0] <= TOL_GRAD, f"train {name}: gradient {worst[1]} off by {worst[0]:.3e}")
        for e_k, e_p, k in errs:
            check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
                  f"train {name}: gradient {k} {e_k:.3e} from float64, the fp32 "
                  f"all-plain run only {e_p:.3e}")

        ce0 = trainer.evaluate(ds)["ce"]
        torch.cuda.synchronize()
        reset_counts()
        c0 = counts()
        t0 = time.perf_counter()
        ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(TRAIN_EPOCHS)]
        torch.cuda.synchronize()
        launched[name] = diff(counts(), c0)
        secs = time.perf_counter() - t0
        ce1 = trainer.evaluate(ds)["ce"]
        print(f"train {name}: {TRAIN_EPOCHS} epochs x {TRAIN_TRIALS} trials "
              f"({steps} Adam steps) in {secs:.2f} s; epoch CE {np.round(ces, 4).tolist()}; "
              f"eval CE {ce0:.4f} -> {ce1:.4f}; launches {json.dumps(launched[name])}",
              flush=True)
        check(np.isfinite(ces).all() and ce1 < ce0, f"train {name}: CE did not fall")
        want = ({"rt_fused": n_layers, "rt_fused_bwd": n_layers} if fused else
                {"gcn_core": 2 * n_layers, "gcn_grads": n_layers, "window_sum": 2 * n_layers})
        per_step = {k: v / steps for k, v in launched[name].items()}
        check(per_step == {k: want.get(k, 0) for k in per_step},
              f"train {name}: launches per step {per_step}, want {want}")
    set_rt_fused(False)
    # the two forms run different kernels for the same gradients
    worst = worst_grad_err(kernel_grads["fused"], kernel_grads["unfused"])
    print(f"train: fused vs unfused first-step gradients (both on the kernels), worst "
          f"relative error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_FORMS:g})", flush=True)
    check(worst[0] <= TOL_FORMS, f"train: the two forms' gradients differ by {worst[0]:.3e}")
    return launched


def throughput_phase():
    """train_throughput at 8 x 1024 frames: fp32 and bf16, unfused and fused."""
    from stgx_torch.bench import train_throughput
    from stgx_torch.ops.rt_fused import set_rt_fused

    records = []
    for dtype in ("float32", "bfloat16"):
        for fused in (False, True):
            argv = ["--dtype", dtype, "--trials", str(N_TRAIN), "--frames", str(L_TRAIN),
                    "--profile"]
            records.append(train_throughput.main(argv + (["--fused"] if fused else [])))
    set_rt_fused(False)
    return records


# ------------------------------------------------------------ Gamma = 69


def gamma69_kernel_phase(recs, layers):
    """window_sum at Gamma = 69: the 9 layers' shapes (into the kernels line
    as g69_ figures), the ragged shapes, repeatability."""
    import torch

    from stgx_torch.ops.window_sum import window_sum, window_sum_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    print("window_sum vs plain at Gamma=69 (csrc/window_sum.cu)", flush=True)
    window_records(recs, "g69_", [(cout, s) for _, cout, s in layers], 69, rnd)
    for n_, l_, v_, c_, gamma, s in RAGGED_WS:
        x32 = rnd(n_, l_, v_, c_)
        for dt in (torch.float32, torch.bfloat16):
            x = x32.to(dt)
            for rev in (False, True):
                check_equal(f"window_sum {(n_, l_, v_, c_, gamma, s)} {str(dt)[6:]}"
                            f"{' reverse' if rev else ''}", window_sum(x, gamma, s, rev),
                            window_sum_plain(x, gamma, s, rev))
            # one element in: no pointer aligned for a 16-byte load (the scalar route)
            off = torch.empty(x.numel() + 1, dtype=dt, device="cuda")[1:].view(x.shape)
            off.copy_(x)
            check_equal(f"window_sum {(n_, l_, v_, c_, gamma, s)} {str(dt)[6:]} misaligned",
                        window_sum(off, gamma, s), window_sum_plain(x, gamma, s))
    print(f"  window_sum: the plain version's bits at {len(RAGGED_WS)} ragged shapes, both "
          f"directions, fp32 and bf16, and misaligned", flush=True)
    x = rnd(N_BATCH, L_BATCH, 25, 256)
    check_repeatable("window_sum", lambda: (window_sum(x, 69, 1), window_sum(x, 69, 2, True)))


def gamma69_phase(cfg):
    """RT-ST-GCN at Gamma = 69 (CONFIG_69), full width, random weights from
    the config's seed. Every layer's halo is past the fused kernel's limit,
    so with set_rt_fused on or off a batch forward launches gcn_core and
    window_sum only; its logits against the all-plain run. One unfused train
    step of N_TRAIN x L_TRAIN frames: its launches, peak memory, and first
    step gradients against the all-plain run in float64. Returns the launch
    counts of the forward and the train step."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.ops.rt_fused import set_rt_fused
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    model = build_model(cfg, NUM_CLASSES)
    n = len(model.layers)
    check(model.kernel == 69, f"{CONFIG_69}: Gamma {model.kernel}")
    rng = np.random.default_rng(SEED + 5)
    x = torch.tensor(rng.normal(size=(N_BATCH, L_BATCH, model.num_joints, model.in_feat)),
                     dtype=torch.float32, device="cuda")
    none = {k: 0 for k in counts()}
    parts, ys = {}, {}
    with torch.inference_mode():
        for fused in (False, True):
            set_rt_fused(fused)
            name = "fused" if fused else "unfused"
            reset_counts()
            ys[name] = model(x)
            torch.cuda.synchronize()
            parts[name] = counts()
            check(parts[name] == {**none, "gcn_core": n, "window_sum": n},
                  f"Gamma=69 batch forward ({name} asked) launched {parts[name]}")
        set_rt_fused(False)
        before = counts()
        with plain_ops():
            y_plain = model(x)
        check(counts() == before, "the plain reference run launched a kernel")
        for name, y in ys.items():
            check(y.shape == (N_BATCH, L_BATCH, NUM_CLASSES), f"shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y).all()), f"Gamma=69 batch form {name}: non-finite")
            err, rel = rel_err(y, y_plain)
            print(f"Gamma=69 batch form ({name} asked) vs all-plain: max abs err {err:.3e} "
                  f"(relative {rel:.3e}, tolerance {TOL_MODEL:g}); launches "
                  f"{json.dumps(parts[name])}", flush=True)
            check(rel <= TOL_MODEL, f"Gamma=69 batch form {name}: relative error {rel:.3e}")
        ms = time_ms(lambda: model(x), reps=5, warm=1)
        with plain_ops():
            plain_ms = time_ms(lambda: model(x), reps=5, warm=1)
    print(f"Gamma=69 batch form forward, N={N_BATCH} x L={L_BATCH}, fp32: {ms:.3f} ms "
          f"({N_BATCH * L_BATCH / ms * 1e3:.0f} frames/s); all-plain {plain_ms:.3f} ms",
          flush=True)

    # one unfused train step, every trial full length
    trainer = Trainer(model=model, kind="frame",
                      loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                      opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                          batch_size=N_TRAIN, seed=SEED),
                      bucket=L_TRAIN, trial_batch=N_TRAIN)
    xt = torch.tensor(rng.normal(size=(N_TRAIN, L_TRAIN, model.num_joints, model.in_feat)),
                      dtype=torch.float32, device="cuda")
    yt = torch.tensor(rng.integers(0, NUM_CLASSES, size=(N_TRAIN, L_TRAIN)), device="cuda")
    batch = (xt, yt, torch.ones((N_TRAIN, L_TRAIN), dtype=torch.float32, device="cuda"))
    before = counts()
    exact = float64_grads(trainer, batch)
    with plain_ops():
        ref = first_step_grads(trainer, batch)
    check(counts() == before, "the all-plain training steps launched a kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    got = first_step_grads(trainer, batch)
    torch.cuda.synchronize()
    parts["train"] = counts()
    peak = torch.cuda.max_memory_allocated()
    want = {**none, "gcn_core": 2 * n, "gcn_grads": n, "window_sum": 2 * n}
    print(f"Gamma=69 train step, {N_TRAIN} x {L_TRAIN} frames: launches "
          f"{json.dumps(parts['train'])}; peak device memory {peak / 2**20:.1f} MiB",
          flush=True)
    check(parts["train"] == want, f"Gamma=69 train step launched {parts['train']}, want {want}")
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          "Gamma=69 train: non-finite gradients")
    worst, plain32 = worst_grad_err(got, exact), worst_grad_err(ref, exact)
    print(f"Gamma=69 train: first-step gradients vs all-plain float64, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD:g}); the fp32 all-plain run's "
          f"{plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 all-plain "
          f"{worst_grad_err(got, ref)[0]:.3e}", flush=True)
    errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k) for k in exact),
                  reverse=True)
    for e_k, e_p, k in errs[:5]:
        print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64", flush=True)
    check(worst[0] <= TOL_GRAD, f"Gamma=69 train: gradient {worst[1]} off by {worst[0]:.3e}")
    for e_k, e_p, k in errs:
        check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
              f"Gamma=69 train: gradient {k} {e_k:.3e} from float64, the fp32 all-plain run "
              f"only {e_p:.3e}")
    return parts


def gamma69_throughput_phase(cfg):
    """train_throughput at Gamma = 69, 8 x 1024 frames, fp32 and bf16, and
    window_sum's share of the device time of a step (a profile of every
    kernel of train_throughput's step)."""
    import numpy as np

    from stgx_torch.bench import train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    records = []
    for dtype in ("float32", "bfloat16"):
        rec = train_throughput.main(["--config", CONFIG_69, "--dtype", dtype, "--trials",
                                     str(N_TRAIN), "--frames", str(L_TRAIN), "--profile"])
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                          opt=OptimizerConfig(learning_rate=1e-4), compute_dtype=dtype)
        prof = train_throughput.profile_steps(
            train_throughput.make_step(trainer, N_TRAIN, L_TRAIN), top=None)
        window = sum(t["ms"] for t in prof["top_kernels"] if "window_kernel<" in t["name"])
        rec["window_share"] = window / prof["device_busy_ms_per_step"]
        records.append(rec)
    return records


# ---------------------------------------------------------------- Shift-GCN


def shift_shapes(cfg):
    """``{(L, C, stride): launches per forward}`` of the temporal shift in a
    Shift-GCN forward of W-frame windows: two per unit, the second with the
    unit's stride."""
    from stgx_torch.config import build_model

    model = build_model(cfg, NUM_CLASSES, device="cpu")
    shapes, l = {}, cfg["arch"]["receptive_field"]
    for unit in model.units:
        c = unit.temporal.shift_in.shape[0]
        shapes[(l, c, 1)] = shapes.get((l, c, 1), 0) + 1
        shapes[(l, c, unit.stride)] = shapes.get((l, c, unit.stride), 0) + 1
        l = -(-l // unit.stride)
    return shapes


def shift_kernel_phase(shapes):
    """The temporal_shift kernel against its plain version at each shape of
    the Shift-GCN forward, SG_WINDOWS windows, fp32 and bf16, with shifts
    that are integers, negative, fractional, exactly +-8 and beyond +-8.
    Returns its record of the ``kernels`` line: times and bounds summed over
    one forward's launches (each shape times its launches)."""
    import numpy as np
    import torch

    from stgx_torch.ops.shift import (
        temporal_shift,
        temporal_shift_bwd,
        temporal_shift_plain,
        temporal_shift_vjp_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rng = np.random.default_rng(SEED)
    cases = [0.0, 1.0, -2.0, 3.0, 0.25, -0.75, 2.5, -3.3, 8.0, -8.0, 9.7, -12.0, 7.6,
             -7.9, 0.5, 5.01]
    recs = {}
    print("temporal_shift vs plain (csrc/temporal_shift.cu)", flush=True)
    for (l, c, s), count in shapes.items():
        shift = rng.uniform(-10.0, 10.0, size=c).astype(np.float32)
        shift[: len(cases)] = cases
        shift = torch.tensor(shift, device="cuda")
        x32 = torch.randn(SG_WINDOWS, l, 25, c, generator=gen, device="cuda")
        shape = (SG_WINDOWS, l, 25, c, s)
        errs = {}
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x = x32.to(dt)
            errs[dt] = compare("temporal_shift", shape, lambda: temporal_shift(x, shift, s),
                               lambda: temporal_shift_plain(x, shift, s), str(dt)[6:], tol)
            check_repeatable("temporal_shift", lambda: (temporal_shift(x, shift, s),))
        ms = time_ms(lambda: temporal_shift(x32, shift, s))
        plain_ms = time_ms(lambda: temporal_shift_plain(x32, shift, s))
        lo = -(-l // s)
        # one read of x and of the shifts, one write of y; 3 operations an
        # output (two products, one add, not fused)
        nbytes = 4 * (SG_WINDOWS * 25 * c * (l + lo) + c)
        b = bound(nbytes, 0, instr=3 * SG_WINDOWS * lo * 25 * c)
        print(f"  x {count} launches per forward", flush=True)
        add_record(recs, "temporal_shift", shape, errs[torch.float32], count * ms,
                   count * plain_ms, None, tuple(count * t for t in b))

        # the backward kernel at a train step's SG_THROUGHPUT_WINDOWS windows
        n = SG_THROUGHPUT_WINDOWS
        x32, g32 = x32[:n], torch.randn(n, lo, 25, c, generator=gen, device="cuda")
        shape = (n, l, 25, c, s)
        err = 0.0
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            x, g, sh = x32.to(dt), g32.to(dt), shift.to(dt)
            gx, gs = temporal_shift_bwd(x, sh, g, s)
            ref_gx, ref_gs = temporal_shift_vjp_plain(x, sh, g, s)
            check_equal(f"temporal_shift_bwd {shape} {str(dt)[6:]} gx", gx, ref_gx)
            e, rel = rel_err(gs, ref_gs)
            print(f"  temporal_shift_bwd {shape} {str(dt)[6:]}: gx the plain version's bits; "
                  f"g_shift max abs err {e:.3e} (relative {rel:.3e}, tolerance {tol:g})",
                  flush=True)
            check(bool(torch.isfinite(gs.float()).all()), "temporal_shift_bwd: non-finite")
            check(rel <= tol, f"temporal_shift_bwd {shape} {dt}: g_shift relative error {rel:.3e}")
            check_repeatable("temporal_shift_bwd", lambda: temporal_shift_bwd(x, sh, g, s))
            if dt == torch.float32:
                err = e
        ms = device_ms(lambda: temporal_shift_bwd(x32, shift, g32, s))
        plain_ms = device_ms(lambda: temporal_shift_vjp_plain(x32, shift, g32, s), calls=3)
        # one read of g and x, one write of gx (and the shifts, g_shift);
        # 3 operations an input element (gx), 3 an output (g_shift's product,
        # difference and add)
        nbytes = 4 * (n * 25 * c * (lo + 2 * l) + 2 * c)
        b = bound(nbytes, 0, instr=3 * n * 25 * c * (l + lo))
        add_record(recs, "temporal_shift_bwd", shape, err, count * ms, count * plain_ms, None,
                   tuple(count * t for t in b))
    return recs


def shift_serving_phase(cfg):
    """Shift-GCN serving with the counters at zero: the offline forward of
    SG_WINDOWS windows and the window streaming cell at B = 1, each against
    its all-plain run; under LayerNorm the streamed logits against the
    offline ones. Returns the launch counts of the two."""
    import numpy as np
    import torch

    from stgx_torch.bench.streaming import measure_stream_latency
    from stgx_torch.config import build_model, load_config
    from stgx_torch.parallel.segments import sliding_windows

    w = cfg["arch"]["receptive_field"]
    model = build_model(cfg, NUM_CLASSES)
    capture = torch.tensor(np.random.default_rng(SEED + 3).normal(
        size=(1, SG_WINDOWS, model.num_joints, model.in_feat)),
        dtype=torch.float32, device="cuda")
    windows = sliding_windows(capture, w)[0]
    none = {k: 0 for k in counts()}
    parts = {}

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    with torch.inference_mode():
        y = model(windows)
        torch.cuda.synchronize()
    parts["offline"] = counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"Shift-GCN offline forward, {SG_WINDOWS} windows of {w} frames: launches "
          f"{json.dumps(parts['offline'])}; peak device memory {peak / 2**20:.1f} MiB "
          f"({(peak - base) / 2**20:.1f} MiB above the model and input)", flush=True)
    check(parts["offline"] == {**none, "temporal_shift": 20},
          f"Shift-GCN offline forward launched {parts['offline']}, want 20 temporal_shift")
    with torch.inference_mode(), plain_ops():
        y_plain = model(windows)
    check(y.shape == (SG_WINDOWS, NUM_CLASSES), f"Shift-GCN logits shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "Shift-GCN offline forward: non-finite logits")
    err, rel = rel_err(y, y_plain)
    print(f"Shift-GCN offline forward vs all-plain: max abs err {err:.3e} (relative "
          f"{rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"Shift-GCN offline forward: relative error {rel:.3e}")
    with torch.inference_mode():
        ms = time_ms(lambda: model(windows), reps=5, warm=1)
        with plain_ops():
            plain_ms = time_ms(lambda: model(windows), reps=5, warm=1)
    print(f"Shift-GCN offline forward, {SG_WINDOWS} windows, fp32: {ms:.3f} ms "
          f"({SG_WINDOWS / ms * 1e3:.0f} windows/s); all-plain {plain_ms:.3f} ms", flush=True)

    # the window streaming cell, B = 1, 20 warm-up steps
    frames = capture[0, :SG_STREAM]
    reset_counts()
    mean, p50, p99, logits = measure_stream_latency(model, frames, window=w)
    parts["streaming"] = counts()
    logits = torch.as_tensor(logits)
    steps = 20 + SG_STREAM
    check(parts["streaming"] == {**none, "temporal_shift": 20 * steps},
          f"window cell launched {parts['streaming']}, want {20 * steps} temporal_shift")
    with plain_ops():
        _, plain_p50, _, logits_plain = measure_stream_latency(model, frames, window=w)
    logits_plain = torch.as_tensor(logits_plain)
    check(bool(torch.isfinite(logits).all()), "window cell: non-finite logits")
    err, rel = rel_err(logits, logits_plain)
    print(f"Shift-GCN window cell B=1 x {SG_STREAM} frames vs all-plain: max abs err "
          f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g}); step mean {mean:.4f} "
          f"ms, p50 {p50:.4f} ms, p99 {p99:.4f} ms; all-plain p50 {plain_p50:.4f} ms",
          flush=True)
    check(rel <= TOL_MODEL, f"window cell: relative error {rel:.3e}")

    # LayerNorm takes no batch statistics: frame t streamed == window t offline
    ln = build_model(load_config(SG_CONFIG, ["arch.normalization=LayerNorm"]), NUM_CLASSES)
    with torch.inference_mode():
        y_off = ln(windows[:SG_LN_FRAMES])
    _, _, _, y_stream = measure_stream_latency(ln, frames[:SG_LN_FRAMES], warmup=1, window=w)
    err, rel = rel_err(torch.as_tensor(y_stream), y_off.cpu())
    print(f"LayerNorm Shift-GCN streamed == offline windows, {SG_LN_FRAMES} frames: max "
          f"abs err {err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"window cell != offline windows under LayerNorm: {rel:.3e}")
    return parts


def float64_window_grads(trainer, chunk, divisor):
    """A window-kind first step's parameter gradients in float64: a copy of
    the model and the chunk in float64 through the all-plain path, with the
    loss and divisor of ``first_step_grads``."""
    import copy

    import torch

    model = copy.deepcopy(trainer.model).double()
    x, y, mask = chunk
    with plain_ops():
        out = model(x.double(), mask=mask[:, None].expand(x.shape[0], x.shape[1]),
                    train=True)[None]
        ce, mse = trainer.loss(out, y[None], mask[None])
        ((ce + mse) / divisor).backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    check(all(g.dtype == torch.float64 for g in grads.values()),
          "the float64 witness lost its precision")
    return grads


def shift_training_phase(cfg, data_dir):
    """The window-kind training path at full width: synthetic PKU-MMD trials
    through the Trainer in chunks of SG_SEGMENT windows. Checks 20 launches
    a chunk step, the first step's gradients against the all-plain run in
    float64 and a falling CE; returns the launch counts."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=SG_TRIALS, num_val=0, min_len=SG_LEN[0], max_len=SG_LEN[1],
             seed=SEED + 1)
    ds = SkeletonDirDataset(os.path.join(data_dir, "train", "features"),
                            os.path.join(data_dir, "train", "labels"))
    trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="window",
                      loss=LOSS["shift-gcn"](class_distribution(ds, NUM_CLASSES)),
                      opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                          batch_size=SG_BS, seed=SEED),
                      receptive_field=cfg["arch"]["receptive_field"], segment=SG_SEGMENT,
                      bucket=SG_SEGMENT)
    chunks = [len(trainer.chunks(*trainer.prepare(*ds[i]))) for i in range(len(ds))]
    chunk0 = trainer.chunks(*trainer.prepare(*ds[0]))[0]
    divisor = float(SG_BS * chunks[0])
    before = counts()
    exact = float64_window_grads(trainer, chunk0, divisor)
    with plain_ops():
        ref = first_step_grads(trainer, chunk0, divisor)
    check(counts() == before, "the all-plain training steps launched a kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    got = first_step_grads(trainer, chunk0, divisor)
    peak = torch.cuda.max_memory_allocated()
    print(f"Shift-GCN train step, one chunk of {chunk0[0].shape[0]} windows: peak device "
          f"memory {peak / 2**20:.1f} MiB", flush=True)
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          "Shift-GCN train: non-finite gradients")
    # a bias added just before a batch norm (the spatial block's, its
    # down-projection's, the residual conv's) has a zero gradient in exact
    # arithmetic: held to zero at the model's gradient scale, not its own
    zero = sorted(k for k in exact if k.endswith(("spatial.bias", "down_bias", "res_bias")))
    scale = max(g.abs().max().item() for g in exact.values())
    noise = max((got[k].abs().max().item() / scale, k) for k in zero)
    print(f"Shift-GCN train: {len(zero)} gradients that are zero in exact arithmetic, "
          f"largest {noise[0]:.3e} of the model's largest gradient ({noise[1]}, "
          f"tolerance {TOL_GRAD:g})", flush=True)
    check(noise[0] <= TOL_GRAD, f"Shift-GCN train: gradient {noise[1]} is {noise[0]:.3e}")
    got, ref, exact = ({k: v for k, v in d.items() if k not in zero} for d in (got, ref, exact))
    worst = worst_grad_err(got, exact)
    plain32 = worst_grad_err(ref, exact)
    print(f"Shift-GCN train: first-step gradients vs all-plain float64, worst relative "
          f"error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD_SG:g}); the fp32 all-plain "
          f"run's {plain32[0]:.3e} ({plain32[1]}); kernels vs fp32 all-plain "
          f"{worst_grad_err(got, ref)[0]:.3e}", flush=True)
    errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                   for k in exact), reverse=True)
    for e_k, e_p, k in errs[:5]:
        print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64", flush=True)
    check(worst[0] <= TOL_GRAD_SG,
          f"Shift-GCN train: gradient {worst[1]} off by {worst[0]:.3e}")
    for e_k, e_p, k in errs:
        check(e_k <= GRAD_VS_PLAIN * e_p + TOL_FORMS,
              f"Shift-GCN train: gradient {k} {e_k:.3e} from float64, the fp32 all-plain "
              f"run only {e_p:.3e}")

    ce0 = trainer.evaluate(ds)["ce"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(SG_EPOCHS)]
    torch.cuda.synchronize()
    launched = counts()
    secs = time.perf_counter() - t0
    ce1 = trainer.evaluate(ds)["ce"]
    steps = SG_EPOCHS * sum(chunks)
    print(f"Shift-GCN train: {SG_EPOCHS} epochs x {SG_TRIALS} trials ({chunks} chunks of "
          f"{SG_SEGMENT} windows, {steps} chunk steps) in {secs:.2f} s; epoch CE "
          f"{np.round(ces, 4).tolist()}; eval CE {ce0:.4f} -> {ce1:.4f}; launches "
          f"{json.dumps(launched)}", flush=True)
    check(np.isfinite(ces).all() and ce1 < ce0, "Shift-GCN train: CE did not fall")
    want = {**{k: 0 for k in launched}, "temporal_shift": 20 * steps,
            "temporal_shift_bwd": 20 * steps}
    check(launched == want, f"Shift-GCN train: launches {launched}, want {want}")
    return launched


def shift_throughput_phase():
    """train_throughput for Shift-GCN, SG_THROUGHPUT_WINDOWS windows a step,
    fp32 and bf16."""
    from stgx_torch.bench import train_throughput

    return [train_throughput.main(["--config", SG_CONFIG, "--trials",
                                   str(SG_THROUGHPUT_WINDOWS), "--dtype", dtype, "--profile"])
            for dtype in ("float32", "bfloat16")]


# ---------------------------------------------------------------- CoST-GCN


def conv_share(prof):
    """(device ms, ms of the temporal convs, forward and backward) of a
    ``profiled`` trace: every CUDA kernel's own time, and the device time
    under the ``temporal_conv`` ranges and the backward nodes of its two
    routes (the taps' Function and cuDNN's convolution)."""
    from torch.autograd import DeviceType

    avg = [e for e in prof.key_averages()]
    total = sum(e.self_device_time_total for e in avg
                if e.device_type == DeviceType.CUDA and e.key != "temporal_conv")
    # a backward node shows as its engine call and as itself, one inside the
    # other: count the outer one only
    backward = [e for e in avg if e.device_type == DeviceType.CPU
                and e.key.endswith(("_TapConvBackward", "ConvolutionBackward0"))]
    outer = [e for e in backward if e.key.startswith("autograd::engine::evaluate_function")]
    conv = sum(e.device_time_total for e in avg
               if e.device_type == DeviceType.CPU and e.key == "temporal_conv")
    conv += sum(e.device_time_total for e in (outer or backward))
    return total / 1e3, conv / 1e3


def profiled(fn):
    """A torch.profiler trace of one call of ``fn`` after a warm call, each
    CoST-GCN temporal conv inside a ``temporal_conv`` range."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import stgx_torch.models.costgcn as costgcn

    real = costgcn.temporal_conv

    def ranged(*args, **kwargs):
        with record_function("temporal_conv"):
            return real(*args, **kwargs)

    with mock.patch.object(costgcn, "temporal_conv", ranged):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    return prof


def temporal_conv_phase():
    """CoST-GCN's temporal conv at its 9 layers' shapes (N_BATCH x L_BATCH
    frames), Gamma = 9 and 69, fp32 and bf16: the port's route
    (``conv_route``: cuDNN or the taps) against cuDNN's ``F.conv2d`` on the
    same inputs, forward times summed over the layers beside the bound.
    cuDNN's bf16 convolution at Gamma = 69 takes seconds a call and is not
    timed (PERF.md)."""
    import torch
    import torch.nn.functional as F

    from stgx_torch.config import build_model
    from stgx_torch.ops.temporal import conv_route, temporal_conv

    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)

    def cudnn(x, W, d):
        xp = F.pad(x, (0, 0, 0, 0, (W.shape[0] - 1) * d, 0))
        return F.conv2d(xp.permute(0, 3, 1, 2), W.permute(2, 1, 0)[..., None],
                        dilation=(d, 1)).permute(0, 2, 3, 1)

    for gamma, config in ((9, CO_CONFIG), (69, CO_CONFIG_69)):
        model = build_model(load_cfg(config), NUM_CLASSES, device="cpu")
        for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
            ms = lib_ms = bound_ms = 0.0
            routes, timed = [], dt == torch.float32 or gamma <= 17
            for cout, d in zip(model.out_ch, model.dilation):
                x = torch.randn(N_BATCH, L_BATCH, 25, cout, generator=gen, device="cuda").to(dt)
                W = (torch.randn(gamma, cout, cout, generator=gen, device="cuda")
                     * (cout * gamma) ** -0.5).to(dt)
                routes.append(conv_route("cuda", dt, gamma, d))
                y = temporal_conv(x, W, dilation=d, padding="causal")
                check(bool(torch.isfinite(y.float()).all()), f"temporal conv {x.shape}: non-finite")
                ms += time_ms(lambda: temporal_conv(x, W, dilation=d, padding="causal"),
                              reps=5, warm=1)
                flops = 2 * x.shape[0] * x.shape[1] * 25 * gamma * cout * cout
                bound_ms += bound(2 * x.numel() * x.element_size() + W.numel() * W.element_size(),
                                  flops, str(dt)[6:])[0]
                if timed:
                    err, rel = rel_err(y, cudnn(x, W, d))
                    check(rel <= tol, f"temporal conv Gamma={gamma} {str(dt)[6:]} C={cout} d={d}: "
                          f"the port's route off cuDNN's by {rel:.3e}")
                    lib_ms += time_ms(lambda: cudnn(x, W, d), reps=5, warm=1)
            lib = f"{lib_ms:.3f} ms" if timed else "not timed (seconds a call)"
            print(f"temporal conv over the 9 layers, Gamma={gamma}, {str(dt)[6:]}, N={N_BATCH} x "
                  f"L={L_BATCH}: the port {ms:.3f} ms (routes {','.join(routes)}), cuDNN "
                  f"F.conv2d {lib}, bound {bound_ms:.3f} ms", flush=True)


def costgcn_forward_phase():
    """The CoST-GCN batch form, N_BATCH x L_BATCH, with the counters at zero:
    Gamma = 9 in fp32 and bf16, Gamma = 69 in fp32. Each forward launches
    gcn_core once a layer; logits against the all-plain run in fp32 (to
    TOL_MODEL) and, in bf16, against the fp32 all-plain run, held to
    GRAD_VS_PLAIN times the bf16 all-plain run's own distance from it (nine
    layers of bf16 roundings, where the kernel rounds the aggregate as the
    TPU kernel did and the plain version does not); forward ms, peak device
    memory and the temporal convs' share of the device time. Returns the
    launch counts."""
    import copy

    import numpy as np
    import torch

    from stgx_torch.config import build_model

    none = {k: 0 for k in counts()}
    parts = {}
    for gamma, config in ((9, CO_CONFIG), (69, CO_CONFIG_69)):
        model = build_model(load_cfg(config), NUM_CLASSES)
        n = len(model.layers)
        check(model.kernel == gamma, f"{config}: Gamma {model.kernel}")
        x32 = torch.tensor(np.random.default_rng(SEED + 7).normal(
            size=(N_BATCH, L_BATCH, model.num_joints, model.in_feat)),
            dtype=torch.float32, device="cuda")
        for dt in (torch.float32, torch.bfloat16)[: 2 if gamma == 9 else 1]:
            name = f"CoST-GCN Gamma={gamma} batch form {str(dt)[6:]}"
            m = model if dt == torch.float32 else copy.deepcopy(model).to(dt)
            x = x32.to(dt)
            with torch.inference_mode():
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                reset_counts()
                y = m(x)
                torch.cuda.synchronize()
                parts[name] = counts()
                peak = torch.cuda.max_memory_allocated()
                check(parts[name] == {**none, "gcn_core": n},
                      f"{name} launched {parts[name]}, want {n} gcn_core")
                before = counts()
                with plain_ops():
                    y_plain = m(x)
                check(counts() == before, "the plain reference run launched a kernel")
                check(y.shape == (N_BATCH, L_BATCH, NUM_CLASSES), f"{name}: shape {y.shape}")
                check(bool(torch.isfinite(y.float()).all()), f"{name}: non-finite logits")
                err, rel = rel_err(y, y_plain)
                ms = time_ms(lambda: m(x), reps=5, warm=1)
                total, conv = conv_share(profiled(lambda: m(x)))
            if dt == torch.float32:
                y_plain32, tol, against = y_plain, TOL_MODEL, ""
            else:  # both bf16 runs against the fp32 all-plain one
                rel_plain = rel_err(y_plain, y_plain32)[1]
                err, rel = rel_err(y, y_plain32)
                tol = GRAD_VS_PLAIN * rel_plain
                against = (f" (the bf16 all-plain run {rel_plain:.3e} from it, the kernel run "
                           f"{rel_err(y, y_plain)[1]:.3e} from the bf16 all-plain run)")
            print(f"{name} vs fp32 all-plain: max abs err {err:.3e} (relative {rel:.3e}, "
                  f"tolerance {tol:.3g}){against}; forward N={N_BATCH} x L={L_BATCH} {ms:.3f} "
                  f"ms ({N_BATCH * L_BATCH / ms * 1e3:.0f} frames/s); device {total:.3f} ms, of "
                  f"it the temporal convs {conv:.3f} ms ({100 * conv / total:.1f} %); "
                  f"peak device memory {peak / 2**20:.1f} MiB", flush=True)
            check(rel <= tol, f"{name}: relative error {rel:.3e}")
    return parts


def costgcn_streaming_phase():
    """The CoST-GCN serving cell through ``serving.py --model co-st-gcn``,
    with the counters at zero: B in {1, B_STREAM} x L_STREAM frames at
    Gamma = 9 and B = 1 x L_STREAM at Gamma = 69, gcn_core once a layer a
    step; the streamed logits against the batch form's (CO_STREAM frames,
    past every FIFO's depth); peak device memory of the cell at B_PEAK_CO.
    Returns the launch counts."""
    import numpy as np
    import torch

    from stgx_torch.bench import serving
    from stgx_torch.config import build_model
    from stgx_torch.models.costgcn import init_stream_state, stream_sequence

    none = {k: 0 for k in counts()}
    parts = {}
    for gamma, config, batches in ((9, CO_CONFIG, [1, B_STREAM]), (69, CO_CONFIG_69, [1])):
        reset_counts()
        records = serving.main(["--model", "co-st-gcn", "--config", config, "--batches",
                                ",".join(map(str, batches)), "--frames", str(L_STREAM)])
        name = f"CoST-GCN Gamma={gamma} serving"
        parts[name] = counts()
        model = build_model(load_cfg(config), NUM_CLASSES)
        n, steps = len(model.layers), len(batches) * (serving.WARMUP_STEPS + L_STREAM)
        check(parts[name] == {**none, "gcn_core": n * steps},
              f"{name} launched {parts[name]}, want {n * steps} gcn_core")
        for rec in records:
            print(f"{name} B={rec['streams']}: step p50 {rec['step_ms_p50']:.4f} ms, "
                  f"p99 {rec['step_ms_p99']:.4f} ms", flush=True)
        # where a step of the B_STREAM-stream cell spends its device time
        reset_counts()
        prof = serving.profile_steps(model, B_STREAM)
        parts[name + " profile"] = counts()
        print(f"{name} B={B_STREAM} profiled: step {prof['step_ms']:.4f} ms, device busy "
              f"{100 * prof['device_busy_share']:.1f} %, {prof['launches_per_step']:.0f} "
              f"launches a step; most device time: " + "; ".join(
                  f"{k['name'][:60]} {k['ms_per_step']:.4f} ms x{k['per_step']:.0f}"
                  for k in prof["top_kernels"]), flush=True)

        x = torch.tensor(np.random.default_rng(SEED + 8).normal(
            size=(2, CO_STREAM, model.num_joints, model.in_feat)),
            dtype=torch.float32, device="cuda")
        reset_counts()
        with torch.inference_mode():
            y_batch = model(x)
            y_stream, _ = stream_sequence(model, x)
        torch.cuda.synchronize()
        parts[name + " == batch"] = counts()
        check(bool(torch.isfinite(y_stream).all()), f"{name}: non-finite streamed logits")
        err, rel = rel_err(y_stream, y_batch)
        print(f"CoST-GCN Gamma={gamma} streamed == batch form, 2 x {CO_STREAM} frames: max "
              f"abs err {err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
        check(rel <= TOL_MODEL, f"CoST-GCN Gamma={gamma}: stream != batch, {rel:.3e}")

        b = B_PEAK_CO[gamma]
        del y_batch, y_stream
        state = sum(t.numel() * t.element_size() for layer in init_stream_state(model)
                    for t in layer.values())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        step_ms, _ = serving.measure_step_latency(model, b, frames=CO_PEAK_FRAMES, warmup=2)
        torch.cuda.synchronize()
        parts[name + " peak"] = counts()
        peak = torch.cuda.max_memory_allocated()
        # the shift FIFOs are written anew every frame: the state read and written
        copy_ms = 2 * b * state / PEAK_BYTES_S * 1e3
        print(f"CoST-GCN Gamma={gamma} serving cell at B={b}: state {state / 1e6:.2f} MB a "
              f"stream, {b * state / 2**20:.1f} MiB in all; peak device memory "
              f"{peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above the model); step "
              f"p50 {np.percentile(step_ms, 50):.4f} ms over {CO_PEAK_FRAMES} frames, of it "
              f"the FIFOs' rewrite at least {copy_ms:.4f} ms (bytes)", flush=True)
    return parts


def drift_phase():
    """check_stream_drift of the bf16 cell against the fp32 one, DRIFT_B
    streams x DRIFT_FRAMES frames, CoST-GCN9 and RT-ST-GCN9 at their
    canonical configs, held to tests/test_serving.py's bounds. Returns the
    launch counts."""
    import torch

    from stgx_torch.bench import serving
    from stgx_torch.config import build_model

    parts = {}
    for name, config in (("co-st-gcn", CO_CONFIG), ("rt-st-gcn", CONFIG)):
        model = build_model(load_cfg(config), NUM_CLASSES)
        reset_counts()
        drift = serving.check_stream_drift(model, l=DRIFT_FRAMES, batch=DRIFT_B,
                                           dtype=torch.bfloat16)
        parts[f"drift {name}"] = counts()
        print(f"drift {name} ({config}), bf16 cell vs fp32, B={DRIFT_B} x {DRIFT_FRAMES} "
              f"frames: {json.dumps(drift)}", flush=True)
        check(drift["top1_agreement"] > 0.8, f"drift {name}: top-1 agreement {drift}")
        check(drift["max_rel_drift"] < 0.25, f"drift {name}: relative drift {drift}")
        check(drift["max_abs_drift_second_half"]
              < 5 * drift["max_abs_drift_first_half"] + 1e-3,
              f"drift {name}: the drift grows along the stream {drift}")
    return parts


def gcn_core_channels_first(x, A, W):
    """The graph-conv core's plain function with its sums in the other
    order: channels mixed first (x·W_p), then joints (·A_p), in fp32."""
    import torch

    acc = torch.promote_types(x.dtype, torch.float32)
    t = torch.einsum("rvc,pcd->rpvd", x.to(acc), W.to(x.dtype).to(acc))
    return torch.einsum("rpvd,pvw->rwd", t, A.to(x.dtype).to(acc)).to(x.dtype)


def costgcn_training_phase(data_dir):
    """The CoST-GCN training path at full width: synthetic PKU-MMD trials of
    CO_TRAIN_LEN frames in one L_TRAIN bucket (their length masks),
    N_TRAIN a step. At Gamma = 9 and 69 one step's launches (gcn_core for y
    and gx, gcn_grads once a layer), peak device memory and first-step
    gradients against the all-plain run in float64; at Gamma = 9 then
    CO_EPOCHS epochs with a falling CE. Returns the launch counts."""
    import numpy as np
    import torch

    import stgx_torch.ops.graph_conv as gconv
    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.parallel.segments import pad_to_bucket
    from stgx_torch.utils import LOSS

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=N_TRAIN, num_val=0, min_len=CO_TRAIN_LEN[0], max_len=CO_TRAIN_LEN[1],
             seed=SEED + 9)
    ds = SkeletonDirDataset(os.path.join(data_dir, "train", "features"),
                            os.path.join(data_dir, "train", "labels"))
    dist = class_distribution(ds, NUM_CLASSES)
    trials = [pad_to_bucket(*ds[i], L_TRAIN) for i in range(N_TRAIN)]
    none = {k: 0 for k in counts()}
    parts = {}
    for gamma, config in ((9, CO_CONFIG), (69, CO_CONFIG_69)):
        name = f"CoST-GCN Gamma={gamma} train"
        cfg = load_cfg(config)
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind="frame",
                          loss=LOSS["co-st-gcn"](dist),
                          opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                              batch_size=CO_TRAIN_BS, seed=SEED),
                          bucket=L_TRAIN, trial_batch=N_TRAIN)
        n = len(trainer.model.layers)
        batch = trainer.stack_trials(*zip(*trials))
        before = counts()
        t0 = time.perf_counter()
        exact = float64_grads(trainer, batch)
        t64 = time.perf_counter() - t0
        with plain_ops():
            ref = first_step_grads(trainer, batch)
            with mock.patch.object(gconv, "gcn_core", gcn_core_channels_first):
                ref_c = first_step_grads(trainer, batch)
        check(counts() == before, "the all-plain training steps launched a kernel")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        got = first_step_grads(trainer, batch)
        torch.cuda.synchronize()
        parts[name] = counts()
        peak = torch.cuda.max_memory_allocated()
        want = {**none, "gcn_core": 2 * n, "gcn_grads": n}
        print(f"{name} step, {N_TRAIN} x {L_TRAIN} frames: launches "
              f"{json.dumps(parts[name])}; peak device memory {peak / 2**20:.1f} MiB; the "
              f"float64 witness took {t64:.1f} s", flush=True)
        check(parts[name] == want, f"{name} step launched {parts[name]}, want {want}")
        check(all(bool(torch.isfinite(g).all()) for g in got.values()),
              f"{name}: non-finite gradients")
        worst, plain32 = worst_grad_err(got, exact), worst_grad_err(ref, exact)
        own = GRAD_VS_PLAIN * plain32[0] + TOL_FORMS
        print(f"{name}: first-step gradients vs all-plain float64, worst relative error "
              f"{worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD_CO[gamma]:g}, and this run's "
              f"{own:.3e}); the fp32 all-plain run's {plain32[0]:.3e} ({plain32[1]}); kernels "
              f"vs fp32 all-plain {worst_grad_err(got, ref)[0]:.3e}", flush=True)
        errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                       for k in exact), reverse=True)
        for e_k, e_p, k in errs[:5]:
            print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64",
                  flush=True)
        # why no per-parameter check: a second all-plain run, its graph conv
        # summed in the other order, breaks one as often as the kernels do
        over = {run: sorted(k for k in exact if grad_err(g[k], exact[k])
                            > GRAD_VS_PLAIN * grad_err(ref[k], exact[k]) + TOL_FORMS)
                for run, g in (("kernels", got), ("channels-first all-plain", ref_c))}
        print(f"{name}: parameters further from float64 than {GRAD_VS_PLAIN:g}x the "
              f"all-plain run + {TOL_FORMS:g}: " + "; ".join(
                  f"{run} {len(ks)} {ks[:3]}" for run, ks in over.items())
              + f"; the channels-first run's worst {worst_grad_err(ref_c, exact)[0]:.3e}",
              flush=True)
        check(worst[0] <= min(TOL_GRAD_CO[gamma], own),
              f"{name}: gradient {worst[1]} off by {worst[0]:.3e}")
        del exact, ref, ref_c, got
        if gamma != 9:
            continue
        ce0 = trainer.evaluate(ds)["ce"]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with step_launches() as steps:
            ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(CO_EPOCHS)]
        torch.cuda.synchronize()
        parts[name + " epochs"] = counts()
        ce1 = trainer.evaluate(ds)["ce"]
        print(f"{name}: {CO_EPOCHS} epochs x {N_TRAIN} trials ({len(steps)} grad steps) in "
              f"{time.perf_counter() - t0:.2f} s; epoch CE {np.round(ces, 4).tolist()}; eval "
              f"CE {ce0:.4f} -> {ce1:.4f}", flush=True)
        check_steps(name, steps, {"gcn_core": 2 * n, "gcn_grads": n})
        check(np.isfinite(ces).all() and ce1 < ce0, f"{name}: CE did not fall")
    return parts


def costgcn_throughput_phase():
    """``train_throughput --model co-st-gcn`` at N_TRAIN x L_TRAIN frames,
    fp32 and bf16 (step p50, frames/s, MFU, HBM share, busy share, launches
    a step), and the temporal convs' share of a step's device time."""
    import numpy as np

    from stgx_torch.bench import train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    records = []
    for dtype in ("float32", "bfloat16"):
        rec = train_throughput.main(["--model", "co-st-gcn", "--dtype", dtype, "--trials",
                                     str(N_TRAIN), "--frames", str(L_TRAIN), "--profile"])
        trainer = Trainer(model=build_model(load_cfg(CO_CONFIG), NUM_CLASSES), kind="frame",
                          loss=LOSS["co-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                          opt=OptimizerConfig(learning_rate=1e-4), compute_dtype=dtype)
        total, conv = conv_share(profiled(train_throughput.make_step(trainer, N_TRAIN,
                                                                     L_TRAIN)))
        rec["conv_share"] = conv / total
        records.append(rec)
    return records


# ------------------------------------------------------------ the CLI


@contextmanager
def step_launches():
    """The kernel launches of every ``Trainer.grad_step`` call inside the
    block, one dict a call."""
    from stgx_torch.parallel.loop import Trainer

    steps, real = [], Trainer.grad_step

    def spy(self, *args, **kwargs):
        c0 = counts()
        out = real(self, *args, **kwargs)
        steps.append(diff(counts(), c0))
        return out

    with mock.patch.object(Trainer, "grad_step", spy):
        yield steps


def run_cli(command, config, *overrides):
    """``python -m stgx_torch.cli command --config config --set ...`` in this
    process (so that the launch counters see its kernels); returns what it
    printed, which is echoed indented."""
    import contextlib
    import io

    from stgx_torch import cli

    argv = [command, "--config", config]
    for item in overrides:
        argv += ["--set", item]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"  | {line[:300]}", flush=True)
    check(rc == 0, f"cli {command} {config}: exit code {rc}")
    return text


def cli_data(data_dir, trials, lengths, seed):
    """Synthetic PKU-MMD trials (52 classes, 3 features) and the overrides
    that point a config at them."""
    from stgx_torch.data.synth import generate

    generate(data_dir, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3,
             num_train=trials[0], num_val=trials[1], min_len=lengths[0], max_len=lengths[1],
             seed=seed)
    return [f"processor.data={data_dir}", f"processor.actions={data_dir}/actions.txt",
            "processor.demo=[0]"]


def check_steps(name, steps, want):
    """Every grad step launched ``want``."""
    check(len(steps) > 0, f"{name}: no train step ran")
    full = {k: want.get(k, 0) for k in counts()}
    bad = [s for s in steps if s != full]
    print(f"{name}: {len(steps)} train steps, launches a step {json.dumps(steps[0])}",
          flush=True)
    check(not bad, f"{name}: a train step launched {bad[:1]}, want {full}")


def read_csv(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def checkpoint_err(a_path, b_path):
    """(worst error of checkpoint b against a over its parameters and Adam
    tensors, relative to max(1, max|a|), that tensor's name)."""
    import torch

    a = torch.load(a_path, weights_only=True)
    b = torch.load(b_path, weights_only=True)
    pairs = [(f"model.{k}", a["model"][k], b["model"][k]) for k in a["model"]]
    for i, st in a["optimizer"]["state"].items():
        pairs += [(f"adam.{i}.{k}", v, b["optimizer"]["state"][i][k]) for k, v in st.items()]
    return max((rel_err(y, x)[1], name) for name, x, y in pairs)


def cli_frame_phase(data_dir, config, tag, want, seed):
    """``stgx_torch.cli`` for a frame-kind model at ``config``: train two
    epochs (every step launching ``want``, artifacts, finite losses), resume
    from epoch-0 (within TOL_RESUME of the unbroken run's parameters and Adam
    moments), test on ``final`` (the last epoch's top1_val and F1@k again),
    benchmark (latency line). Returns the launch counts and the command
    line's overrides."""
    import numpy as np

    base = cli_data(data_dir, CLI_TRIALS, CLI_LEN, seed) + [
        "optimizer.epochs=2", "optimizer.checkpoint_indices=[0]",
        f"optimizer.batch_size={CLI_BS}"]
    out = os.path.join(data_dir, tag)
    parts = {}
    reset_counts()
    with step_launches() as steps:
        run_cli("train", config, *base, f"processor.out={out}")
    parts["train"] = counts()
    check_steps(f"cli {tag} train", steps, want)
    for name in ("train-validation-curve.csv", "accuracy-curve.csv", "macro-F1@k-0.csv",
                 "macro-F1@k-1.csv", "edit-0.csv", "edit-1.csv", "confusion-matrix-0.csv",
                 "confusion-matrix-1.csv", "segmentation-0.csv", "epoch-0", "final"):
        check(os.path.exists(os.path.join(out, name)), f"cli {tag} train: no {name}")
    curve = np.asarray(read_csv(os.path.join(out, "train-validation-curve.csv"))[1:], float)
    check(curve.shape[0] == 2 and np.isfinite(curve[:, 1:5]).all(),
          f"cli {tag} train: curve {curve.tolist()}")

    resumed = os.path.join(data_dir, f"{tag}-resumed")
    run_cli("train", config, *base, f"processor.out={resumed}",
            f"processor.checkpoint={out}/epoch-0")
    err, name = checkpoint_err(os.path.join(out, "final"), os.path.join(resumed, "final"))
    print(f"cli {tag}: resumed from epoch-0 vs the unbroken run, final parameters and Adam "
          f"moments: worst relative error {err:.3e} ({name}, tolerance {TOL_RESUME:g})",
          flush=True)
    check(err <= TOL_RESUME, f"cli {tag} resume: {name} off by {err:.3e}")

    reset_counts()
    run_cli("test", config, *base, f"processor.out={out}", f"processor.checkpoint={out}/final")
    parts["test"] = counts()
    top1 = float(read_csv(os.path.join(out, "accuracy.csv"))[1][0])
    f1 = read_csv(os.path.join(out, "macro-F1@k.csv"))
    print(f"cli {tag} test on final: top1 {top1} (epoch 1's top1_val {curve[1, 7]}), F1@k "
          f"{f1[1]} (epoch 1's {read_csv(os.path.join(out, 'macro-F1@k-1.csv'))[1]})",
          flush=True)
    check(top1 == curve[1, 7], f"cli {tag} test: top1 is not the last epoch's top1_val")
    # the F1@k, edit and confusion counts (every prediction against its
    # label) of the last epoch's evaluation, again
    for name in ("macro-F1@k", "edit", "confusion-matrix"):
        check(read_csv(os.path.join(out, f"{name}.csv"))
              == read_csv(os.path.join(out, f"{name}-1.csv")),
              f"cli {tag} test: {name}.csv is not the last epoch's")

    reset_counts()
    text = run_cli("benchmark", config, *base, f"processor.out={out}",
                   f"processor.checkpoint={out}/final")
    parts["benchmark"] = counts()
    bench = json.loads([line for line in text.splitlines() if line.startswith("{")][-1])
    check(bench["latency_ms_per_frame"] > 0 and bench["p99_ms"] > 0
          and bench["clock"] == "cuda_events", f"cli {tag} benchmark: {bench}")
    for name in ("latency.csv", "model-size.csv", "accuracy.csv"):
        check(os.path.exists(os.path.join(out, name)), f"cli {tag} benchmark: no {name}")
    return parts, base


def cli_rt_phase(data_dir):
    """``stgx_torch.cli`` for RT-ST-GCN9 at its canonical config
    (``cli_frame_phase``), then one fused train epoch. Returns the launch
    counts."""
    from stgx_torch.ops.rt_fused import set_rt_fused

    set_rt_fused(False)
    n = len(load_cfg(CONFIG)["arch"]["rt-st-gcn"]["in_ch"])
    parts, base = cli_frame_phase(data_dir, CONFIG, "rt9",
                                  {"gcn_core": 2 * n, "gcn_grads": n, "window_sum": 2 * n},
                                  SEED + 2)
    reset_counts()
    with step_launches() as steps:
        run_cli("train", CONFIG, *base, "optimizer.epochs=1", "arch.rt_fused=true",
                f"processor.out={os.path.join(data_dir, 'rt9-fused')}")
    set_rt_fused(False)
    parts["train_fused"] = counts()
    check_steps("cli rt9 train, arch.rt_fused", steps, {"rt_fused": n, "rt_fused_bwd": n})
    return parts


def cli_gamma69_phase(data_dir, config=CONFIG_69, tag="Gamma=69", want=None, seed=SEED + 3):
    """``stgx_torch.cli`` train (one epoch) and test at Gamma = 69, every
    train step launching ``want`` (RT-ST-GCN's unfused kernels if None)."""
    base = cli_data(data_dir, CLI_TRIALS, CLI_LEN, seed) + [
        "optimizer.epochs=1", f"processor.out={os.path.join(data_dir, 'g69')}"]
    n = len(build_cfg_layers(config))
    if want is None:
        want = {"gcn_core": 2 * n, "gcn_grads": n, "window_sum": 2 * n}
    reset_counts()
    with step_launches() as steps:
        run_cli("train", config, *base)
    parts = {"train": counts()}
    check_steps(f"cli {tag} train", steps, want)
    reset_counts()
    run_cli("test", config, *base)
    parts["test"] = counts()
    check(parts["test"]["gcn_core"] > 0 and parts["test"]["gcn_core"] % n == 0
          and all(parts["test"][k] > 0 for k in want if k != "gcn_grads"),
          f"cli {tag} test: {parts['test']}")
    return parts


def cli_costgcn_phase(data_dir):
    """``stgx_torch.cli`` for CoST-GCN: Gamma = 9 (``cli_frame_phase``) and
    Gamma = 69 (one epoch and test), each train step launching gcn_core for
    y and gx and gcn_grads once a layer. Returns the launch counts."""
    n = len(build_cfg_layers(CO_CONFIG))
    want = {"gcn_core": 2 * n, "gcn_grads": n}
    parts, _ = cli_frame_phase(os.path.join(data_dir, "g9"), CO_CONFIG, "co9", want, SEED + 10)
    for k, v in cli_gamma69_phase(os.path.join(data_dir, "g69"), CO_CONFIG_69,
                                  "CoST-GCN Gamma=69", want, SEED + 11).items():
        parts[f"g69 {k}"] = v
    return parts


def build_cfg_layers(config):
    """The layer widths (in_ch) a config builds: the family's own sub-dict,
    else the st-gcn one the builder falls back to."""
    cfg = load_cfg(config)
    arch = cfg["arch"]
    return arch.get(cfg["processor"]["model"], arch.get("st-gcn"))["in_ch"]


def cli_shift_phase(data_dir):
    """``stgx_torch.cli`` for Shift-GCN (W = 50) through the window kind:
    one train epoch in chunks of SG_SEGMENT windows (20 launches of the
    shift and of its backward a chunk step), test, benchmark."""
    out = os.path.join(data_dir, "shift")
    base = cli_data(data_dir, CLI_SG_TRIALS, CLI_SG_LEN, SEED + 4) + [
        "optimizer.epochs=1", f"arch.segment={SG_SEGMENT}", f"processor.out={out}"]
    reset_counts()
    with step_launches() as steps:
        run_cli("train", SG_CONFIG, *base)
    parts = {"train": counts()}
    check_steps("cli Shift-GCN train", steps,
                {"temporal_shift": 20, "temporal_shift_bwd": 20})
    reset_counts()
    run_cli("test", SG_CONFIG, *base)
    parts["test"] = counts()
    check(os.path.exists(os.path.join(out, "segmentation-0.csv")), "cli Shift-GCN: no demo")
    reset_counts()
    text = run_cli("benchmark", SG_CONFIG, *base)
    parts["benchmark"] = counts()
    bench = json.loads([line for line in text.splitlines() if line.startswith("{")][-1])
    check(bench["latency_ms_per_frame"] > 0 and bench["p99_ms"] > 0,
          f"cli Shift-GCN benchmark: {bench}")
    check(parts["benchmark"]["temporal_shift"] > 0, "cli Shift-GCN benchmark: no shift kernel")
    return parts


def load_cfg(path, overrides=()):
    from stgx_torch.config import load_config

    return load_config(path, list(overrides))


def remat_phase():
    """One RT9 and one CoST-GCN9 train step (N_TRAIN x L_TRAIN, dropout
    REMAT_DROPOUT from an explicit generator) and one Shift-GCN chunk step
    (SG_SEGMENT windows) with ``arch.remat`` on and off: gradients within
    TOL_GRAD of each other, peak device memory of each."""
    import numpy as np
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    rng = np.random.default_rng(SEED + 6)
    w = load_cfg(SG_CONFIG)["arch"]["receptive_field"]
    cases = {
        "rt-st-gcn": (CONFIG, "frame", [f"arch.rt-st-gcn.dropout={[REMAT_DROPOUT] * 9}"],
                      (N_TRAIN, L_TRAIN), (N_TRAIN, L_TRAIN)),
        "shift-gcn": (SG_CONFIG, "window", [], (SG_SEGMENT, w), (SG_SEGMENT,)),
        # the ln configs keep CoST-GCN's layers under "st-gcn"
        "co-st-gcn": (CO_CONFIG, "frame", [f"arch.st-gcn.dropout={[REMAT_DROPOUT] * 9}"],
                      (N_TRAIN, L_TRAIN), (N_TRAIN, L_TRAIN)),
    }
    for name, (config, kind, sets, shape, series) in cases.items():
        x = torch.tensor(rng.normal(size=(*shape, 25, 3)), dtype=torch.float32, device="cuda")
        y = torch.tensor(rng.integers(0, NUM_CLASSES, size=series), device="cuda")
        mask = torch.ones(series, dtype=torch.float32, device="cuda")
        grads, peak = {}, {}
        for remat in (False, True):
            cfg = load_cfg(config, sets + [f"arch.remat={str(remat).lower()}"])
            trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind=kind,
                              loss=LOSS[name](np.ones(NUM_CLASSES, np.float32)),
                              opt=OptimizerConfig(), receptive_field=w)
            check(trainer.model.remat == remat, f"{name}: arch.remat did not reach the model")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            trainer.grad_step(x, y, mask, 1.0,
                              torch.Generator(device="cuda").manual_seed(SEED))
            torch.cuda.synchronize()
            peak[remat] = torch.cuda.max_memory_allocated()
            grads[remat] = {k: p.grad.detach().clone()
                            for k, p in trainer.model.named_parameters()}
            del trainer
        worst = worst_grad_err(grads[True], grads[False])
        print(f"remat {name}, one train step of {shape}: gradients vs the stored step, worst "
              f"relative error {worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD:g}); peak "
              f"device memory {peak[True] / 2**20:.1f} MiB with remat, "
              f"{peak[False] / 2**20:.1f} MiB without", flush=True)
        check(all(bool(torch.isfinite(g).all()) for g in grads[True].values()),
              f"remat {name}: non-finite gradients")
        check(worst[0] <= TOL_GRAD, f"remat {name}: gradient {worst[1]} off by {worst[0]:.3e}")


def headline_phase(smi):
    """The headline's functions at HEADLINE_FRAMES frames: the CUDA graph's
    logits against graph-free stream_sequence over 256 frames, the result
    line, and the peak device memory of the serving cell at B = 4096 and of
    one fp32 RT9 train step at N_TRAIN x L_TRAIN."""
    import numpy as np
    import torch

    from stgx_torch.bench import headline, serving, train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.models.rtstgcn import stream_sequence
    from stgx_torch.parallel.loop import OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    cfg = load_cfg(CONFIG)
    model = build_model(cfg, NUM_CLASSES)
    frame_ms, dispatch_ms, stream = headline.streaming_figures(model, HEADLINE_FRAMES, 2)
    ref, _ = stream_sequence(model, stream.frames[None, :256])
    err, rel = rel_err(stream.logits[:256], ref[0])
    print(f"headline: CUDA-graph logits vs graph-free stream_sequence, 256 frames: max abs "
          f"err {err:.3e} (relative {rel:.3e}, tolerance {TOL_GRAPH:g})", flush=True)
    check(bool(torch.isfinite(stream.logits).all()), "headline: non-finite logits")
    check(rel <= TOL_GRAPH, f"headline: graph logits off by {rel:.3e}")
    result = headline.assemble(frame_ms, dispatch_ms, smi, headline.train_figures(cfg))
    print(f"headline at {HEADLINE_FRAMES} frames a repeat: {json.dumps(result)}", flush=True)
    check(result["value"] > 0 and result["train_frames_per_s_bf16"] > 0,
          f"headline: {result}")

    del stream
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    serving.measure_step_latency(model, B_PEAK, frames=8, warmup=2)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    trainer = Trainer(model=model, kind="frame",
                      loss=LOSS["rt-st-gcn"](np.ones(NUM_CLASSES, np.float32)),
                      opt=OptimizerConfig(learning_rate=1e-4))
    step = train_throughput.make_step(trainer, N_TRAIN, L_TRAIN)
    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    train_peak = torch.cuda.max_memory_allocated()
    print(f"peak device memory: RT9 serving cell at B={B_PEAK} {serve_peak / 2**20:.1f} MiB; "
          f"one fp32 RT9 train step of {N_TRAIN} x {L_TRAIN} frames {train_peak / 2**20:.1f} "
          f"MiB", flush=True)


# ------------------------------------------------------------ the int8 cells


def quant_sites(config):
    """``(name, model, [(site, per_joint, K, N, taps)])`` of the int8 cell of
    the model at ``config``: its product sites in step order, the weight's
    shape, whether the rows are B x V (else B, the classifier), and for
    CoST-GCN's temporal convs the ``(gamma, dilation)`` of the FIFO whose
    taps the product reads (else None)."""
    from stgx_torch.bench.quant import QUANT_MODELS
    from stgx_torch.config import build_model

    cfg = load_cfg(config)
    name = cfg["processor"]["model"]
    model = build_model(cfg, NUM_CLASSES)
    q = QUANT_MODELS[name][0](model)
    sites = [("fcn_in", True, *q["fcn_in"][0].shape, None)]
    for i, lq in enumerate(q["layers"]):
        sites += [(f"layers.{i}.{key}", True, *lq[key][0].shape,
                   (model.kernel, model.dilation[i]) if key == "tcn" else None)
                  for key in ("res", "gcn", "tcn") if key in lq]
    sites.append(("fcn_out", False, *q["fcn_out"][0].shape, None))
    return name, model, sites


def route_counts():
    """Launches by route of the two int8 products."""
    return {f"{name}.{r}": n for name, fn in _int8_wrappers().items()
            for r, n in fn.route_launches.items()}


def int8_kernel_phase(recs):
    """int8_gemm and w8_gemm against their plain versions at every product
    site of RT9's and CoST9's int8 cells (INT8_KERNEL_B), CoST at
    Gamma = 69's temporal-conv sites at B_STREAM and RAGGED_INT8, in every
    form of the left operand (after a check of the quantize inside the
    product against PyTorch's division on 8 x QUANT_CHECK values): int8 codes
    (form a), contiguous and as a slot
    of an (M, 3, K) FIFO (row stride 3K); fp32 and bf16 quantized inside the
    product (form b, fp32 also on exact .5 ties of x / s and past the clamp,
    bf16 only where the tma route takes the shape; w8 takes them as they
    are); and at the temporal-conv
    sites the FIFO's taps (form c) over int8, fp32 and bf16 state. int8 with
    torch.equal, w8 within TOL_FP32; every one repeats bit for bit. Each
    shape prints the route its launches took. Device times of the kernels
    (form a and form b fp32 for int8, fp32 for w8; form c at the tcn sites),
    the plain versions, and the yardsticks (torch._int_mm where it takes the
    shape; torch.matmul on a prepared fp32 weight) beside the bounds (int8
    at the int8 tensor-core peak, w8 at the two-pass TF32 one, each at least
    the bytes). The kernels line takes the sums over one step of RT9's and of
    CoST9's cell at B_STREAM streams, and lists the shapes of LARGE_INT8."""
    import torch

    from stgx_torch.ops.int8_gemm import (
        int8_gemm,
        int8_gemm_plain,
        tma_ok,
        w8_gemm,
        w8_gemm_plain,
        weight_layout,
    )

    weight = {}  # (M, K, N, taps) -> times one step of the line's cells uses it
    for config, batches in INT8_KERNEL_B.items():
        _, _, sites = quant_sites(config)
        for b in batches:
            for _, per_joint, k, n, taps in sites:
                shape = (b * 25 if per_joint else b, k, n, taps)
                weight[shape] = weight.get(shape, 0) + (b == B_STREAM)
    _, _, sites69 = quant_sites(CO_CONFIG_69)
    for site, _, k, n, taps in sites69:
        if taps is not None:
            weight.setdefault((B_STREAM * 25, k, n, taps), 0)
    for m, k, n in RAGGED_INT8:
        weight.setdefault((m, k, n, None), 0)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def codes(*shape):
        return torch.randint(-127, 128, shape, generator=gen, device="cuda",
                             dtype=torch.int32).to(torch.int8)

    # the quantize inside the product against PyTorch's division: codes times
    # s through an identity weight, over QUANT_CHECK values under each of 8
    # scales, infinities and quotients past fp32's range among them (outputs
    # equal exactly when the codes do)
    eye = weight_layout(torch.eye(64, dtype=torch.int8, device="cuda"))
    ones = torch.ones(64, device="cuda")
    differ = 0
    for _ in range(8):
        s = torch.rand((), generator=gen, device="cuda") * 0.05 + 1e-4
        xq = torch.randn(QUANT_CHECK // 64, 64, generator=gen, device="cuda") * s * 60
        xq[0, :4] = torch.tensor([float("inf"), -float("inf"), 3e38, -3e38])
        differ += int((int8_gemm(xq, eye, s, ones) != int8_gemm_plain(xq, eye, s, ones)).sum())
    print(f"int8_gemm's quantize against the plain version's: {differ} of {8 * QUANT_CHECK} "
          "codes differ", flush=True)
    check(differ == 0, f"int8_gemm: {differ} codes differ from the plain quantize's")
    del eye, xq

    def held(name, shape, got, again, ref):
        """int8: the plain version's bits; w8: within TOL_FP32. Both
        repeatable. Returns the max abs error."""
        if name == "int8_gemm":
            check_equal(f"int8_gemm {shape}", got, ref)
            err = 0.0
        else:
            torch.cuda.synchronize()
            err, rel = rel_err(got, ref)
            check(bool(torch.isfinite(got).all()) and rel <= TOL_FP32,
                  f"w8_gemm {shape}: relative error {rel:.3e}")
        check(torch.equal(got, again), f"{name} {shape}: not repeatable")
        return err

    keys = ("ms", "plain_ms", "library_ms", "library_kernel_ms", "bound_ms", "_tb", "_to")
    # each kernel's timed forms (fp32_in_ms, bf16_in_ms, taps_ms) join its
    # sums as they are measured: a key no shape measured is not printed
    sums = {k: {**{key: 0.0 for key in keys}, "max_abs_err": 0.0}
            for k in ("int8_gemm", "w8_gemm")}
    large = {}
    print(f"int8 products at {len(weight)} shapes (M, K, N); the kernels line sums one step "
          f"of RT9's and CoST9's int8 cells at B={B_STREAM}", flush=True)
    for (m, k, n, taps), w in sorted(weight.items(), key=lambda kv: kv[0][:3]):
        shape = (m, k, n)
        b = weight_layout(codes(k, n))
        s_a = torch.rand((), generator=gen, device="cuda") * 0.02 + 0.005
        s_b = torch.rand(n, generator=gen, device="cuda") * 0.02
        bias = torch.randn(n, generator=gen, device="cuda")
        a, fifo = codes(m, k), codes(m, 3, k)
        x = torch.randn(m, k, generator=gen, device="cuda")
        x16 = x.to(torch.bfloat16)
        xfifo = torch.randn(m, 3, k, generator=gen, device="cuda")
        # exact ties of x / s (s a power of two) and codes past the clamp
        s_tie = torch.full((), 2.0 ** -7, device="cuda")
        ties = (torch.randint(-140, 140, (m, k), generator=gen, device="cuda") + 0.5) * s_tie
        forms = {  # name -> [(label, args, kwargs)]
            "int8_gemm": [("codes", (a,), {}), ("codes, row stride 3K", (fifo[:, 1],), {}),
                          ("fp32", (x * 0.3,), {})],
            "w8_gemm": [("fp32", (x,), {}), ("fp32, row stride 3K", (xfifo[:, 1],), {})],
        }
        bf16_ok = tma_ok(x16, b, n)  # a bf16 operand takes the tma route only
        if bf16_ok:
            forms["int8_gemm"].append(("bf16", (x16 * 0.3,), {}))
            forms["w8_gemm"].append(("bf16", (x16,), {}))
        tfifo = None
        if taps is not None:  # the FIFO (depth, B, V, C) of the site's taps
            gamma, d = taps
            c = k // gamma
            depth = (gamma - 1) * d + 1
            tfifo = {"int8": codes(depth, m // 25, 25, c),
                     "fp32": torch.randn(depth, m // 25, 25, c, generator=gen, device="cuda")}
            tfifo["bf16"] = tfifo["fp32"].to(torch.bfloat16)
            for sd, f in tfifo.items():
                forms["int8_gemm"].append((f"taps {sd} state", (f if sd == "int8" else f * 0.3,),
                                           {"taps": taps}))
                if sd != "int8":
                    forms["w8_gemm"].append((f"taps {sd} state", (f,), {"taps": taps}))
        errs = {"int8_gemm": 0.0, "w8_gemm": 0.0}
        routes = {}
        got, again = int8_gemm(ties, b, s_tie, s_b, bias), int8_gemm(ties, b, s_tie, s_b, bias)
        held("int8_gemm", f"{shape} fp32 ties", got, again,
             int8_gemm_plain(ties, b, s_tie, s_b, bias))
        for name, fn, plain in (("int8_gemm", int8_gemm, int8_gemm_plain),
                                ("w8_gemm", w8_gemm, w8_gemm_plain)):
            lead = (s_a,) if name == "int8_gemm" else ()
            for label, args, kw in forms[name]:
                before = route_counts()
                got = fn(args[0], b, *lead, s_b, bias, **kw)
                again = fn(args[0], b, *lead, s_b, bias, **kw)
                took = [r for r, v in diff(route_counts(), before).items() if v]
                routes[f"{name} {label}"] = took[0].split(".")[1]
                ref = plain(args[0], b, *lead, s_b, bias, **kw)
                errs[name] = max(errs[name], held(name, f"{shape} {label}", got, again, ref))
        print(f"  ({m}, {k}, {n}) routes: {json.dumps(routes)}", flush=True)
        bf = b.float().contiguous()
        ms = {
            "int8_gemm": device_ms(lambda: int8_gemm(a, b, s_a, s_b, bias)),
            "w8_gemm": device_ms(lambda: w8_gemm(x, b, s_b, bias)),
        }
        extra = {"int8_gemm": {"fp32_in_ms": device_ms(lambda: int8_gemm(x, b, s_a, s_b, bias))},
                 "w8_gemm": {}}
        if bf16_ok:
            extra["int8_gemm"]["bf16_in_ms"] = device_ms(
                lambda: int8_gemm(x16, b, s_a, s_b, bias))
            extra["w8_gemm"]["bf16_in_ms"] = device_ms(lambda: w8_gemm(x16, b, s_b, bias))
        if tfifo is not None:
            extra["int8_gemm"]["taps_ms"] = device_ms(
                lambda: int8_gemm(tfifo["fp32"], b, s_a, s_b, bias, taps=taps))
            extra["w8_gemm"]["taps_ms"] = device_ms(
                lambda: w8_gemm(tfifo["fp32"], b, s_b, bias, taps=taps))
        plain = {
            "int8_gemm": device_ms(lambda: int8_gemm_plain(a, b, s_a, s_b, bias), calls=3),
            "w8_gemm": device_ms(lambda: w8_gemm_plain(x, b, s_b, bias), calls=3),
        }
        int_mm_takes = m > 16 and k % 8 == 0 and n % 8 == 0
        lib = {
            "int8_gemm": device_ms(lambda: torch._int_mm(a, b)) if int_mm_takes else None,
            "w8_gemm": device_ms(lambda: torch.matmul(x, bf)),
        }
        flops = 2 * m * n * k
        nbytes = m * k + k * n + 4 * m * n + 8 * n
        bnd = {
            "int8_gemm": bound(nbytes, flops, "int8"),
            "w8_gemm": bound(nbytes + 3 * m * k, 2 * flops, "tf32"),
        }
        for name in ("int8_gemm", "w8_gemm"):
            bb = bnd[name]
            libs = "none" if lib[name] is None else f"{lib[name]:.4f} ms"
            more = "".join(f", {key} {v:.4f}" for key, v in extra[name].items())
            print(f"  {name} ({m}, {k}, {n}) x{w}: kernel {ms[name]:.4f} ms{more}, plain "
                  f"{plain[name]:.4f} ms, library {libs}, bound {bb[0]:.4f} ms "
                  f"({'bytes' if bb[1] >= bb[2] else 'operations'})", flush=True)
            r = sums[name]
            r["max_abs_err"] = max(r["max_abs_err"], errs[name])
            for key, val in (("ms", ms[name]), ("plain_ms", plain[name]), ("bound_ms", bb[0]),
                             ("_tb", bb[1]), ("_to", bb[2]), *extra[name].items()):
                r[key] = r.get(key, 0.0) + w * val
            if lib[name] is not None:
                r["library_ms"] += w * lib[name]
                r["library_kernel_ms"] += w * ms[name]
            if (m, k, n) in LARGE_INT8:
                large[f"{name} {m}x{k}x{n}"] = {"ms": ms[name], **extra[name],
                                                "bound_ms": bb[0], "library_ms": lib[name]}
        del a, fifo, x, x16, xfifo, b, bf, tfifo, ties
    forms = {"fp32_in_ms": "fp32 operand", "bf16_in_ms": "bf16 operand",
             "taps_ms": "the tcn sites' taps"}
    for name, r in sums.items():
        more = ", ".join(f"{what} {r[key]:.4f}" for key, what in forms.items() if key in r)
        print(f"{name} over one step of RT9's and CoST9's cells at B={B_STREAM}: kernel "
              f"{r['ms']:.4f} ms ({more}), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms; library "
              f"{r['library_ms']:.4f} ms against the kernel's {r['library_kernel_ms']:.4f} ms "
              f"at the sites it takes", flush=True)
        recs[name] = r
    for key, v in large.items():
        print(f"large shape {key}: {json.dumps(v)}", flush=True)
    recs["int8_gemm"]["large"] = {k: v for k, v in large.items() if k.startswith("int8")}
    recs["w8_gemm"]["large"] = {k: v for k, v in large.items() if k.startswith("w8")}


def counted(fn, calls):
    """``fn`` that appends to ``calls`` at each call."""
    def wrapped(*args, **kwargs):
        calls.append(1)
        return fn(*args, **kwargs)
    return wrapped


def stream_logits(step, state, x):
    """Logits ``(L, B, classes)`` of ``step(state, x_t)`` over ``x`` ``(L, B,
    V, C)``, synchronised."""
    import torch

    outs = []
    for t in range(x.shape[0]):
        logits, state = step(state, x[t])
        outs.append(logits.float())
    torch.cuda.synchronize()
    return torch.stack(outs)


def track(y, ref):
    """(top-1 agreement, mean |y - ref| over mean |ref|)."""
    agree = (y.argmax(-1) == ref.argmax(-1)).float().mean().item()
    return agree, ((y - ref).abs().mean() / (ref.abs().mean() + 1e-9)).item()


def int8_cell_phase():
    """The int8 cells of RT9, CoST9, RT69 and CoST69 at INT8_CELL_B streams
    x INT8_CELL_L frames, after a calibration (serving.py's 256 frames):
    dynamic, static and w8 with fp32 state, static with bf16 and int8 state.
    Each run with the counters at zero launches exactly one int8_gemm (w8:
    w8_gemm) per product site a step, the sites of calibrate_scales less
    the .state ones, and nothing else; it equals the same cell on the plain
    versions (torch.equal, w8 within TOL_MODEL); CoST-GCN's cells call no
    torch.stack (their temporal convs read the taps from the FIFO); the
    launches by route are printed; it tracks the fp32 cell
    (gcn_core, once a layer a step): mean relative distance < 0.2, bf16 and
    int8 state < 0.15 against the fp32-state static cell, top-1 agreement
    > INT8_TOP1. Then check_stream_drift of
    the int8-state cell (tests/test_serving.py's bounds) and the state's
    bytes. Returns the launch counts of the int8 runs."""
    import numpy as np
    import torch

    import stgx_torch.bench.quant as tq
    from stgx_torch.bench import serving
    from stgx_torch.bench.streaming import streaming_fns
    from stgx_torch.ops.int8_gemm import int8_gemm_plain, w8_gemm_plain

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8}
    none = {k: 0 for k in all_counts()}
    parts = {}
    stack = torch.stack
    for config, tag in INT8_CONFIGS:
        name, model, _ = quant_sites(config)
        quantize, qstep, qinit = tq.QUANT_MODELS[name]
        qparams = quantize(model)
        reset_all_counts()
        scales = tq.calibrate_scales(model, qparams, serving.calibration_frames(model), name)
        parts[f"{tag} calibration"] = all_counts()
        sites = [site for site in scales if not site.endswith(".state")]
        x = torch.tensor(np.random.default_rng(SEED + 21).normal(
            size=(INT8_CELL_L, INT8_CELL_B, model.num_joints, model.in_feat)),
            dtype=torch.float32, device="cuda")
        init, fn = streaming_fns(model)
        reset_all_counts()
        y32 = stream_logits(lambda st, x_t: fn(model, st, x_t), init(model, INT8_CELL_B), x)
        check(all_counts() == {**none, "gcn_core": len(model.layers) * INT8_CELL_L},
              f"{tag} fp32 cell launched {all_counts()}")
        runs = {}
        for mode, sd in INT8_RUNS:
            kernel = "w8_gemm" if mode == "w8" else "int8_gemm"
            cell = f"{tag} int8 {mode} {sd} state"
            step = lambda st, x_t: qstep(model, qparams, st, x_t)  # noqa: E731
            stacks = []

            def counted_step(st, x_t):  # the cell's torch.stack calls, counted
                with mock.patch.object(torch, "stack", counted(stack, stacks)):
                    return step(st, x_t)

            with tq.quant_mode(mode, scales if mode == "static" else None):
                reset_all_counts()
                y = stream_logits(counted_step, qinit(model, INT8_CELL_B, dtypes[sd]), x)
                parts[cell] = all_counts()
                routes = route_counts()
                with mock.patch.object(tq, "int8_gemm", int8_gemm_plain), \
                        mock.patch.object(tq, "w8_gemm", w8_gemm_plain):
                    y_plain = stream_logits(step, qinit(model, INT8_CELL_B, dtypes[sd]), x)
            want = {**none, kernel: len(sites) * INT8_CELL_L}
            check(parts[cell] == want, f"{cell} launched {parts[cell]}, want {want} "
                  f"({len(sites)} sites a step)")
            # CoST-GCN's temporal convs read their taps from the FIFO: no stack
            # (RT-ST-GCN's accumulator stacks its taps outside any product)
            check(name != "co-st-gcn" or not stacks, f"{cell} stacked {len(stacks)} tensors")
            check(bool(torch.isfinite(y).all()), f"{cell}: non-finite logits")
            err, rel = rel_err(y, y_plain)
            same = torch.equal(y, y_plain)
            print(f"{cell}, {INT8_CELL_B} x {INT8_CELL_L} frames: {len(sites)} {kernel} a "
                  f"step (by route {json.dumps({k: v for k, v in routes.items() if v})}; "
                  f"torch.stack {len(stacks)} calls); kernels vs plain versions: "
                  f"{'equal' if same else 'differ'} (max abs err {err:.3e}, relative "
                  f"{rel:.3e})", flush=True)
            if mode == "w8":
                check(rel <= TOL_MODEL, f"{cell}: relative error {rel:.3e} > {TOL_MODEL}")
            else:
                check(same, f"{cell}: not the plain versions' bits ({err:.3e})")
            runs[mode, sd] = y
        for (mode, sd), y in runs.items():
            ref, bound_rel = ((runs["static", "float32"], 0.15) if sd != "float32"
                              else (y32, 0.2))
            agree, rel = track(y, ref)
            print(f"{tag} int8 {mode} {sd} state against the "
                  f"{'fp32-state static' if sd != 'float32' else 'fp32'} cell: top-1 agreement "
                  f"{agree:.4f} (bound > {INT8_TOP1}; the JAX quant tests' 0.9 "
                  f"{'met' if agree > 0.9 else 'not met'}), mean relative distance "
                  f"{rel:.4f} (bound < {bound_rel})", flush=True)
            check(agree > INT8_TOP1 and rel < bound_rel, f"{tag} int8 {mode} {sd}: {agree}, {rel}")
        reset_all_counts()
        drift = serving.check_stream_drift(model, l=DRIFT_FRAMES, batch=DRIFT_B,
                                           quant="int8-static", state_dtype=torch.int8,
                                           scales=scales)
        parts[f"{tag} drift"] = all_counts()
        print(f"{tag} drift of the int8 cell with int8 state against fp32, B={DRIFT_B} x "
              f"{DRIFT_FRAMES} frames: {json.dumps(drift)}", flush=True)
        check(drift["top1_agreement"] > 0.8 and drift["max_rel_drift"] < 0.25
              and drift["max_abs_drift_second_half"]
              < 5 * drift["max_abs_drift_first_half"] + 1e-3, f"{tag} int8 drift {drift}")
        nbytes = {sd: serving.state_bytes(model, 1, quant="int8-static", state_dtype=dt)
                  for sd, dt in dtypes.items()}
        print(f"{tag} FIFO state a stream: {json.dumps(nbytes)} bytes", flush=True)
        check(nbytes["int8"] * 4 == nbytes["float32"] == nbytes["bfloat16"] * 2,
              f"{tag} state bytes {nbytes}")
    return parts


def int8_serving_phase(data_dir):
    """The int8 cell through the entry points a user runs, each with the
    counters at zero. ``serving.py`` at INT8_SERVE streams: the plain fp32
    and bf16 cells and ``--quant int8-static`` with fp32, bf16 and int8
    state (calibration included: one int8_gemm a site for its site-listing
    step and each of its frames, then one a site a step), p50 / p99 a step,
    state bytes, peak memory and the capacity at 30 fps of each variant;
    ``quant_ab`` for the four configs; and ``stgx_torch.cli benchmark`` of
    RT9 and CoST9 with ``processor.quantize`` set, its int8 columns filled.
    Returns the launch counts."""
    import torch

    from stgx_torch.bench import quant_ab, serving

    variants = [("fp32", []), ("bf16", ["--dtype", "bfloat16"]),
                ("int8 fp32 state", ["--quant", "int8-static"]),
                ("int8 bf16 state", ["--quant", "int8-static", "--state-dtype", "bfloat16"]),
                ("int8 int8 state", ["--quant", "int8-static", "--state-dtype", "int8"])]
    none = {k: 0 for k in all_counts()}
    parts = {}
    for config, batches in INT8_SERVE.items():
        name, model, sites = quant_sites(config)
        tag = f"{name} Gamma={model.kernel}"
        steps = len(batches) * (serving.WARMUP_STEPS + INT8_SERVE_FRAMES)
        capacity, state = {}, {}
        for variant, argv in variants:
            reset_all_counts()
            records = serving.main(["--config", config, "--batches",
                                    ",".join(map(str, batches)), "--frames",
                                    str(INT8_SERVE_FRAMES)] + argv)
            got = parts[f"serving {tag} {variant}"] = all_counts()
            if variant.startswith("int8"):
                want = {**none, "int8_gemm": len(sites) * (serving.CALIB_FRAMES + 1 + steps)}
            else:
                want = {**none, "gcn_core": len(model.layers) * steps}
            check(got == want, f"serving {tag} {variant} launched {got}, want {want}")
            for rec in records:
                check(not rec.get("oom"), f"serving {tag} {variant}: out of memory {rec}")
                print(f"int8 serving {tag} {variant} B={rec['streams']}: step p50 "
                      f"{rec['step_ms_p50']:.4f} ms, p99 {rec['step_ms_p99']:.4f} ms, state "
                      f"{rec['state_bytes'] / 2**20:.2f} MiB, peak {rec['peak_mib']:.1f} MiB, "
                      f"real time {rec['realtime']}", flush=True)
                state[variant, rec["streams"]] = rec["state_bytes"]
            capacity[variant] = max([r["streams"] for r in records if r["realtime"]], default=0)
        for b in batches:
            check(state["int8 int8 state", b] * 4 == state["int8 fp32 state", b]
                  == state["fp32", b], f"serving {tag} B={b}: state bytes {state}")
        print(f"int8 serving {tag}: capacity at 30 fps over B in {batches} (largest B whose "
              f"p99 fits 33.3 ms): {json.dumps(capacity)}", flush=True)

    for config, tag in INT8_CONFIGS:
        reset_all_counts()
        res = quant_ab.main(["--config", config, "--frames", str(QUANT_AB_FRAMES),
                             "--repeats", str(QUANT_AB_REPEATS)])
        parts[f"quant_ab {tag}"] = all_counts()
        print(f"quant_ab {tag}: {json.dumps(res)}", flush=True)
        check(all(res[k] > 0 for k in res if k.endswith("_onchip_ms")), f"quant_ab {tag}: {res}")

    for config, tag, seed in ((CONFIG, "rt9", SEED + 22), (CO_CONFIG, "co9", SEED + 23)):
        reset_all_counts()
        sub = os.path.join(data_dir, tag)
        over = cli_data(sub, (2, 1), (300, 400), seed) + [f"processor.out={sub}/out",
                                                          "processor.quantize=true"]
        run_cli("benchmark", config, *over)
        parts[f"CLI benchmark {tag} int8"] = all_counts()
        header, row = read_csv(os.path.join(sub, "out", "latency.csv"))
        cols = dict(zip(header, row))
        print(f"CLI benchmark {tag} latency.csv: {json.dumps(cols)}", flush=True)
        check(all(float(cols[k]) > 0 for k in header), f"CLI benchmark {tag}: {cols}")
        size = read_csv(os.path.join(sub, "out", "model-size.csv"))
        check(size[0] == ["fp32_mb", "int8_mb"] and 0 < float(size[1][1]) < float(size[1][0]),
              f"CLI benchmark {tag}: model-size.csv {size}")
    del model
    torch.cuda.empty_cache()
    return parts


# ----------------------------------------------------------- window models


def window_layer_rows(model, windows, w=50):
    """``(rows, C_in, C_out)`` of each ST-GCN layer's graph conv over
    ``windows`` windows of ``w`` frames: the layer's input frames (before
    its stride) times the windows."""
    rows, l = [], w
    for layer, cin, cout in zip(model.layers, model.in_ch, model.out_ch):
        rows.append((windows * l, cin, cout))
        l = -(-l // layer.stride)
    return rows


def window_kernel_phase(recs):
    """gcn_core at the shapes of ST-GCN's batch form of ST_WINDOWS windows
    and gcn_grads at those of one train step of WIN_TRIAL windows (R =
    windows x 50, 25 and 13 frames; C 64 -> 256), against their plain
    versions in fp32 and bf16, timed beside the plain version, the einsum
    yardstick and the bound. The sums over the 9 layers go into the kernels
    line as ``window_*`` keys of the two kernels."""
    import torch

    from stgx_torch.config import build_model
    from stgx_torch.ops.gcn_core import gcn_core, gcn_core_plain
    from stgx_torch.ops.gcn_grads import gcn_grads, gcn_grads_plain

    model = build_model(load_cfg(ST_CONFIG), NUM_CLASSES)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 31)
    v, p = model.num_joints, model.partitions

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    for name, windows in (("gcn_core", ST_WINDOWS), ("gcn_grads", WIN_TRIAL)):
        print(f"{name} vs plain at ST-GCN's shapes, {windows} windows", flush=True)
        sums = {}
        for rows, cin, cout in window_layer_rows(model, windows):
            A = (model.A * (1.0 + 0.1 * rnd(p, v, v))).contiguous()
            W = rnd(p, cin, cout, scale=cin**-0.5)
            x32, g32 = rnd(rows, v, cin), rnd(rows, v, cout)
            if name == "gcn_core":
                def kern(x, g):
                    return gcn_core(x, A, W)

                def plain(x, g):
                    return gcn_core_plain(x, A, W)

                def lib():
                    return torch.einsum("rvc,pvw,pcd->rwd", x32, A, W)

                flops = 2 * rows * v * p * cin * (v + cout)
                values = rows * v * (cin + cout) + p * v * v + p * cin * cout
            else:
                def kern(x, g):
                    return gcn_grads(x, g, A, W)

                def plain(x, g):
                    return gcn_grads_plain(x, g, A, W)

                def lib():
                    return (torch.einsum("rvc,pvw,rwd->pcd", x32, A, g32),
                            torch.einsum("rvc,rwd,pcd->pvw", x32, g32, W))

                flops = 4 * rows * p * v * cin * (v + cout)
                values = rows * v * (cin + cout) + 2 * (p * v * v + p * cin * cout)
            for dt, tol in ((torch.float32, TOL_FP32), (torch.bfloat16, TOL_BF16)):
                x, g = x32.to(dt), g32.to(dt)
                err = compare(name, (rows, v, cin, cout), lambda: kern(x, g),
                              lambda: plain(x, g), str(dt)[6:], tol)
                if dt == torch.float32:
                    sums["max_abs_err"] = max(sums.get("max_abs_err", 0.0), err)
            b = bound(4 * values, flops)
            for key, val in (("ms", time_ms(lambda: kern(x32, g32))),
                             ("plain_ms", time_ms(lambda: plain(x32, g32), reps=3, warm=1)),
                             ("library_ms", time_ms(lib, reps=3, warm=1)),
                             ("bound_ms", b[0]), ("_tb", b[1]), ("_to", b[2])):
                sums[key] = sums.get(key, 0.0) + val
        by = "bytes" if sums["_tb"] >= sums["_to"] else "operations"
        print(f"  {name} over ST-GCN's 9 layers, {windows} windows, fp32: kernel "
              f"{sums['ms']:.4f} ms, plain {sums['plain_ms']:.4f} ms, einsum "
              f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms ({by}, "
              f"{100 * sums['bound_ms'] / sums['ms']:.1f} % of it)", flush=True)
        r = recs[name]
        r["max_abs_err"] = max(r["max_abs_err"], sums.pop("max_abs_err"))
        r.update({f"window_{k}": val for k, val in sums.items() if not k.startswith("_")})
        r["window_bound_by"] = by
        r["window_windows"] = windows


def window_input(model, frames, seed):
    """The windows of one capture of ``frames`` normal frames: ``(frames,
    50, V, C)`` on the card."""
    import numpy as np
    import torch

    from stgx_torch.parallel.segments import sliding_windows

    capture = torch.tensor(np.random.default_rng(seed).normal(
        size=(1, frames, model.num_joints, model.in_feat)), dtype=torch.float32, device="cuda")
    return sliding_windows(capture, 50)[0]


def stgcn_forward_phase():
    """ST-GCN's batch form over ST_WINDOWS windows, fp32 and bf16, with the
    counters at zero: exactly 9 gcn_core launches a forward; fp32 logits
    against the all-plain run (TOL_MODEL), bf16 within GRAD_VS_PLAIN times
    the bf16 all-plain run's own distance from the fp32 all-plain run;
    windows/s and peak device memory. Returns the launch counts."""
    import copy

    import torch

    from stgx_torch.config import build_model

    model = build_model(load_cfg(ST_CONFIG), NUM_CLASSES)
    n = len(model.layers)
    windows32 = window_input(model, ST_WINDOWS, SEED + 32)
    none = {k: 0 for k in all_counts()}
    parts = {}
    for dt in (torch.float32, torch.bfloat16):
        name = f"ST-GCN batch form {str(dt)[6:]}"
        m = model if dt == torch.float32 else copy.deepcopy(model).to(dt)
        x = windows32.to(dt)
        with torch.inference_mode():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            reset_all_counts()
            y = m(x)
            torch.cuda.synchronize()
            parts[name] = all_counts()
            peak = torch.cuda.max_memory_allocated()
            check(parts[name] == {**none, "gcn_core": n},
                  f"{name} launched {parts[name]}, want {n} gcn_core")
            with plain_ops():
                y_plain = m(x)
            check(all_counts() == parts[name], "the plain reference run launched a kernel")
            check(y.shape == (ST_WINDOWS, NUM_CLASSES), f"{name}: shape {tuple(y.shape)}")
            check(bool(torch.isfinite(y.float()).all()), f"{name}: non-finite logits")
            err, rel = rel_err(y, y_plain)
            ms = time_ms(lambda: m(x), reps=5, warm=1)
            with plain_ops():
                plain_ms = time_ms(lambda: m(x), reps=3, warm=1)
        if dt == torch.float32:
            y_plain32, tol, against = y_plain, TOL_MODEL, ""
        else:
            rel_plain = rel_err(y_plain, y_plain32)[1]
            err, rel = rel_err(y, y_plain32)
            tol = GRAD_VS_PLAIN * rel_plain
            against = (f" (the bf16 all-plain run {rel_plain:.3e} from it, the kernel run "
                       f"{rel_err(y, y_plain)[1]:.3e} from the bf16 all-plain run)")
        print(f"{name} vs fp32 all-plain: max abs err {err:.3e} (relative {rel:.3e}, "
              f"tolerance {tol:.3g}){against}; forward of {ST_WINDOWS} windows {ms:.3f} ms "
              f"({ST_WINDOWS / ms * 1e3:.0f} windows/s), all-plain {plain_ms:.3f} ms; peak "
              f"device memory {peak / 2**20:.1f} MiB ({(peak - base) / 2**20:.1f} MiB above "
              f"the model and input)", flush=True)
        check(rel <= tol, f"{name}: relative error {rel:.3e}")
    return parts


def window_serving_phase():
    """ST-GCN's window cell with the counters at zero: ``serving.py --model
    st-gcn`` at ST_STREAM_B streams (9 gcn_core a step), p50 / p99, and the
    same with ``--quant int8-static`` in fp32 and bf16 state (one int8_gemm
    a site for the calibration's site-listing step and each of its frames,
    then one a site a step); the B = 1 cell against the all-plain cell; the
    B = 1 cell captured in a CUDA graph and replayed (``graph_frame_ms``).
    Returns the launch counts."""
    import numpy as np
    import torch

    from stgx_torch.bench import serving
    from stgx_torch.bench.streaming import graph_frame_ms, measure_stream_latency
    from stgx_torch.config import build_model

    none = {k: 0 for k in all_counts()}
    parts = {}
    n = 9
    reset_all_counts()
    records = serving.main(["--model", "st-gcn", "--batches", ",".join(map(str, ST_STREAM_B)),
                            "--frames", str(ST_STREAM_FRAMES)])
    parts["serving"] = all_counts()
    steps = len(ST_STREAM_B) * (serving.WARMUP_STEPS + ST_STREAM_FRAMES)
    check(parts["serving"] == {**none, "gcn_core": n * steps},
          f"ST-GCN serving launched {parts['serving']}, want {n * steps} gcn_core")
    for rec in records:
        print(f"ST-GCN window cell serving B={rec['streams']}: step p50 {rec['step_ms_p50']:.4f} "
              f"ms, p99 {rec['step_ms_p99']:.4f} ms, state {rec['state_bytes'] / 2**20:.2f} MiB, "
              f"peak {rec['peak_mib']:.1f} MiB, real time {rec['realtime']}", flush=True)
    model = build_model(load_cfg(ST_CONFIG), NUM_CLASSES)
    # the int8 window cell's products a step: fcn_in, each layer's residual
    # conv (where it has one), gcn and tcn, and fcn_out
    sites = 2 + sum(2 + hasattr(layer, "res_kernel") for layer in model.layers)
    for variant, argv in (("int8 fp32 state", []),
                          ("int8 bf16 state", ["--state-dtype", "bfloat16"])):
        reset_all_counts()
        records = serving.main(["--model", "st-gcn", "--quant", "int8-static", "--batches",
                                ",".join(map(str, ST_STREAM_B)), "--frames",
                                str(ST_STREAM_FRAMES)] + argv)
        got = parts[f"serving {variant}"] = all_counts()
        want = {**none, "int8_gemm": sites * (serving.CALIB_FRAMES + 1 + steps)}
        check(got == want, f"ST-GCN serving {variant} launched {got}, want {want}")
        for rec in records:
            check(not rec.get("oom"), f"ST-GCN serving {variant}: out of memory {rec}")
            print(f"ST-GCN window cell serving {variant} B={rec['streams']}: step p50 "
                  f"{rec['step_ms_p50']:.4f} ms, p99 {rec['step_ms_p99']:.4f} ms, state "
                  f"{rec['state_bytes'] / 2**20:.2f} MiB, peak {rec['peak_mib']:.1f} MiB, "
                  f"real time {rec['realtime']}", flush=True)

    frames = torch.tensor(np.random.default_rng(SEED + 33).normal(
        size=(ST_GRAPH_FRAMES, model.num_joints, model.in_feat)), dtype=torch.float32,
        device="cuda")
    reset_all_counts()
    _, p50, p99, logits = measure_stream_latency(model, frames[:ST_STREAM_FRAMES])
    parts["cell"] = all_counts()
    with plain_ops():
        _, plain_p50, _, logits_plain = measure_stream_latency(model, frames[:ST_STREAM_FRAMES])
    err, rel = rel_err(torch.as_tensor(logits), torch.as_tensor(logits_plain))
    reset_all_counts()
    replay = graph_frame_ms(model, frames)
    parts["graph"] = all_counts()
    print(f"ST-GCN window cell B=1 x {ST_STREAM_FRAMES} frames vs all-plain: max abs err "
          f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g}); step p50 {p50:.4f} ms, "
          f"p99 {p99:.4f} ms, all-plain p50 {plain_p50:.4f} ms; the cell replayed from a "
          f"CUDA graph over {ST_GRAPH_FRAMES} frames: {replay:.4f} ms a frame "
          f"(graph_frame_ms)", flush=True)
    check(rel <= TOL_MODEL and bool(np.isfinite(logits).all()),
          f"ST-GCN window cell: relative error {rel:.3e}")
    check(parts["graph"]["gcn_core"] > 0, "the graph replay launched no gcn_core")
    return parts


def window_int8_phase():
    """The int8 ST-GCN window cell at ST_INT8_B streams x ST_INT8_L frames
    after a calibration (serving.py's 256 frames), in dynamic, static and w8
    modes with fp32 and bf16 state: one int8_gemm (w8: w8_gemm) a site a
    step and nothing else, the cell on the plain products equal bit for bit
    (w8 within TOL_MODEL), tracking the fp32 window cell (the int8 cells'
    bounds: mean relative distance < 0.2 with fp32 state, < 0.15 for bf16
    state against the same mode's fp32-state cell, top-1 agreement
    > INT8_TOP1); int8 state refused; the B = 1 cell replayed from a CUDA
    graph in each mode (``measure_quant``). Returns the launch counts."""
    import numpy as np
    import torch

    import stgx_torch.bench.quant as tq
    from stgx_torch.bench import serving
    from stgx_torch.bench.streaming import init_window_state, measure_quant, window_step
    from stgx_torch.config import build_model
    from stgx_torch.ops.int8_gemm import int8_gemm_plain, w8_gemm_plain

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    model = build_model(load_cfg(ST_CONFIG), NUM_CLASSES)
    quantize, qstep, qinit = tq.QUANT_MODELS["st-gcn"]
    qparams = quantize(model)
    none = {k: 0 for k in all_counts()}
    parts = {}
    reset_all_counts()
    calib = serving.calibration_frames(model)
    scales = tq.calibrate_scales(model, qparams, calib, "st-gcn")
    parts["calibration"] = all_counts()
    sites = list(scales)
    x = torch.tensor(np.random.default_rng(SEED + 34).normal(
        size=(ST_INT8_L, ST_INT8_B, model.num_joints, model.in_feat)),
        dtype=torch.float32, device="cuda")
    reset_all_counts()
    with torch.inference_mode():
        y32 = stream_logits(lambda st, x_t: window_step(model, st, x_t),
                            init_window_state(model, ST_INT8_B), x)
    parts["fp32 cell"] = all_counts()
    check(parts["fp32 cell"] == {**none, "gcn_core": 9 * ST_INT8_L},
          f"ST-GCN fp32 window cell launched {parts['fp32 cell']}")
    runs = {}
    for mode, sd in WIN_INT8_RUNS:
        kernel = "w8_gemm" if mode == "w8" else "int8_gemm"
        cell = f"ST-GCN int8 window cell {mode} {sd} state"

        def step(st, x_t):
            return qstep(model, qparams, st, x_t)

        with tq.quant_mode(mode, scales if mode == "static" else None):
            reset_all_counts()
            y = stream_logits(step, qinit(model, ST_INT8_B, dtypes[sd]), x)
            parts[cell] = all_counts()
            routes = route_counts()
            with mock.patch.object(tq, "int8_gemm", int8_gemm_plain), \
                    mock.patch.object(tq, "w8_gemm", w8_gemm_plain):
                y_plain = stream_logits(step, qinit(model, ST_INT8_B, dtypes[sd]), x)
        want = {**none, kernel: len(sites) * ST_INT8_L}
        check(parts[cell] == want, f"{cell} launched {parts[cell]}, want {want}")
        check(bool(torch.isfinite(y).all()), f"{cell}: non-finite logits")
        err, rel = rel_err(y, y_plain)
        same = torch.equal(y, y_plain)
        print(f"{cell}, {ST_INT8_B} x {ST_INT8_L} frames: {len(sites)} {kernel} a step (by "
              f"route {json.dumps({k: v for k, v in routes.items() if v})}); kernels vs plain "
              f"versions: {'equal' if same else 'differ'} (max abs err {err:.3e}, relative "
              f"{rel:.3e})", flush=True)
        if mode == "w8":
            check(rel <= TOL_MODEL, f"{cell}: relative error {rel:.3e} > {TOL_MODEL}")
        else:
            check(same, f"{cell}: not the plain versions' bits ({err:.3e})")
        runs[mode, sd] = y
    for (mode, sd), y in runs.items():
        ref, bound_rel = ((runs[mode, "float32"], 0.15) if sd != "float32" else (y32, 0.2))
        agree, rel = track(y, ref)
        print(f"ST-GCN int8 window cell {mode} {sd} state against the "
              f"{'fp32-state int8' if sd != 'float32' else 'fp32'} cell: top-1 agreement "
              f"{agree:.4f} (bound > {INT8_TOP1}), mean relative distance {rel:.4f} (bound "
              f"< {bound_rel})", flush=True)
        check(agree > INT8_TOP1 and rel < bound_rel, f"ST-GCN int8 {mode} {sd}: {agree}, {rel}")
    try:
        qinit(model, 1, torch.int8)
    except ValueError as e:
        print(f"ST-GCN int8 window cell with int8 state refused: {e}", flush=True)
    else:
        raise SmokeFailure("the ST-GCN int8 window cell took int8 state")
    frames = x[:, 0]
    replays = {}
    reset_all_counts()
    for mode, sd in WIN_INT8_RUNS:
        replays[f"{mode} {sd}"] = measure_quant(model, "st-gcn", qparams, frames, mode=mode,
                                                scales=scales if mode == "static" else None,
                                                state_dtype=dtypes[sd])
    parts["graph replays"] = all_counts()
    print(f"ST-GCN int8 window cell B=1 replayed from a CUDA graph over {ST_INT8_L} frames, "
          f"ms a frame by mode and state: {json.dumps(replays)}", flush=True)
    check(all(v > 0 for v in replays.values()), f"int8 window replays {replays}")
    return parts


def attention_rows(model, x):
    """For each AA-GCN attention ``softmax(θᵀφ)`` of a forward on ``x``, in
    call order: (share of its rows whose maximum is above 0.99, the median
    over rows of the scores' spread, max - min)."""
    import torch

    from stgx_torch.models import aagcn

    rows = []
    softmax = torch.softmax

    def observed(scores, dim):
        p = softmax(scores, dim=dim)
        if scores.dim() == 4:  # (N, P, V, V): an attention, not an output adapter
            spread = scores.amax(dim) - scores.amin(dim)
            rows.append(((p.amax(dim) > 0.99).float().mean().item(),
                         spread.float().median().item()))
        return p

    with torch.inference_mode(), mock.patch.object(aagcn.torch, "softmax", observed):
        model(x)
    return rows


def float64_step_grads(trainer, batch, divisor, seed, perturb=0.0):
    """One Trainer grad step's parameter gradients in float64, for any kind:
    a copy of the model and the batch in float64 through the all-plain path,
    with the loss and divisor of ``first_step_grads`` and dropout drawn from
    a generator seeded ``seed``. ``perturb``: every weight and input value
    first scaled by ``1 ± perturb`` (signs drawn from a generator seeded
    ``seed``), to read the step's own sensitivity to rounding of that size."""
    import copy

    import torch

    model = copy.deepcopy(trainer.model).double()
    x, y, mask = batch
    x = x.double()
    if perturb:
        signs = torch.Generator(device="cuda").manual_seed(seed)

        def jiggle(t):
            r = torch.randint(0, 2, t.shape, generator=signs, device=t.device) * 2 - 1
            t.mul_(1 + perturb * r.to(t.dtype))

        with torch.no_grad():
            for p in model.parameters():
                jiggle(p)
            jiggle(x)
    window = trainer.kind.startswith("window")
    m = mask[:, None].expand(x.shape[0], x.shape[1]) if window else mask
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with plain_ops():
        out = model(x, mask=m, train=True, generator=gen)
        if trainer.kind == "window":
            out = out[None]
        ce, mse = trainer.loss(out, *trainer._series(y, mask))
        ((ce + mse) / divisor).backward()
    grads = {k: p.grad.detach() for k, p in model.named_parameters()}
    check(all(g.dtype == torch.float64 for g in grads.values()),
          "the float64 witness lost its precision")
    return grads


def window_grad_check(tag, name, trainer, batch, divisor, want):
    """One grad step of ``trainer`` on ``batch`` (its dropout from a seeded
    generator): exact launches ``want``, peak device memory, first-step
    gradients against the all-plain run in float64 (the fp32 all-plain
    run's own distance beside; the biases that feed a batch norm held to
    zero at the model's gradient scale). Returns the launch counts."""
    import torch

    def gen():
        return torch.Generator(device="cuda").manual_seed(SEED + 35)

    t0 = time.perf_counter()
    exact = float64_step_grads(trainer, batch, divisor, SEED + 35)
    t64 = time.perf_counter() - t0
    before = all_counts()
    with plain_ops():
        ref = first_step_grads(trainer, batch, divisor, gen())
    check(all_counts() == before, "the all-plain training step launched a kernel")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_counts()
    t0 = time.perf_counter()
    got = first_step_grads(trainer, batch, divisor, gen())
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = all_counts()
    peak = torch.cuda.max_memory_allocated()
    full = {**{k: 0 for k in launched}, **want}
    unit = "windows" if trainer.kind.startswith("window") else "trials"
    print(f"{tag} train step ({batch[0].shape[0]} {unit} of {batch[0].shape[1]} frames): "
          f"launches {json.dumps(launched)}; peak device memory {peak / 2**20:.1f} MiB; step "
          f"{secs:.3f} s (first call); the float64 witness took {t64:.1f} s", flush=True)
    check(launched == full, f"{tag} step launched {launched}, want {full}")
    check(all(bool(torch.isfinite(g).all()) for g in got.values()),
          f"{tag}: non-finite gradients")
    # zero in exact arithmetic: a bias added just before a batch norm (the
    # residual 1x1 conv's, the temporal conv's) and AA-GCN's phi bias (it
    # adds the same score to every column of the attention's softmax)
    zero = sorted(k for k in exact if k.endswith(("res_bias", "tcn_bias", "phi_bias")))
    scale = max(g.abs().max().item() for g in exact.values())
    if zero:
        noise = max((got[k].abs().max().item() / scale, k) for k in zero)
        print(f"{tag}: {len(zero)} gradients that are zero in exact arithmetic under "
              f"BatchNorm, largest {noise[0]:.3e} of the model's largest gradient ({noise[1]}, "
              f"tolerance {TOL_GRAD:g})", flush=True)
        check(noise[0] <= TOL_GRAD, f"{tag}: gradient {noise[1]} is {noise[0]:.3e}")
    got, ref, exact = ({k: v for k, v in d.items() if k not in zero} for d in (got, ref, exact))
    worst, plain32 = worst_grad_err(got, exact), worst_grad_err(ref, exact)
    own = GRAD_VS_PLAIN * plain32[0] + TOL_FORMS
    print(f"{tag}: first-step gradients vs all-plain float64, worst relative error "
          f"{worst[0]:.3e} ({worst[1]}, tolerance {TOL_GRAD_WIN[name]:g}, and this run's "
          f"{own:.3e}); the fp32 all-plain run's {plain32[0]:.3e} ({plain32[1]}); kernels vs "
          f"fp32 all-plain {worst_grad_err(got, ref)[0]:.3e}", flush=True)
    errs = sorted(((grad_err(got[k], exact[k]), grad_err(ref[k], exact[k]), k)
                   for k in exact), reverse=True)
    for e_k, e_p, k in errs[:5]:
        print(f"  {k}: kernels {e_k:.3e}, fp32 all-plain {e_p:.3e} from float64", flush=True)
    median, median32 = errs[len(errs) // 2][0], sorted(e for _, e, _ in errs)[len(errs) // 2]
    # the float64 step's own sensitivity: its gradients again after every
    # weight and input value was scaled by 1 +- 2^-24, fp32's unit roundoff
    moved = float64_step_grads(trainer, batch, divisor, SEED + 35, perturb=2.0 ** -24)
    moved = {k: moved[k] for k in exact}
    sens = sorted(grad_err(moved[k], exact[k]) for k in exact)
    print(f"{tag}: median parameter {median:.3e} from float64 (tolerance "
          f"{TOL_GRAD_WIN_MEDIAN[name]:g}; the fp32 all-plain run's {median32:.3e}); the float64 "
          f"step after a relative 2^-24 perturbation of its weights and input moved "
          f"{sens[-1]:.3e} at worst, {sens[len(sens) // 2]:.3e} at the median, "
          f"{grad_err(moved[worst[1]], exact[worst[1]]):.3e} on {worst[1]}", flush=True)
    check(median <= TOL_GRAD_WIN_MEDIAN[name],
          f"{tag}: the median parameter's gradient is off by {median:.3e}")
    check(worst[0] <= min(TOL_GRAD_WIN[name], own),
          f"{tag}: gradient {worst[1]} off by {worst[0]:.3e}")
    check(want or all(torch.equal(got[k], ref[k]) for k in got),
          f"{tag}: a path without kernels differs from its all-plain run")
    return launched


def window_training_phase(data_dir):
    """The window models' training paths at full width, each with the
    counters at zero. ST-GCN (``window``): one chunk step of WIN_TRIAL
    windows (gcn_core for y and gx, gcn_grads once a layer), first-step
    gradients against float64, then WIN_EPOCHS epochs of WIN_TRIALS trials
    with a falling loss, and ``train_throughput --model st-gcn`` in fp32 and
    bf16 (windows/s). MS-GCN (``window_ms``): one chunk step, the same
    launches, gradients against float64. AA-GCN (``window``): its forward of
    AA_WINDOWS windows and one step, no kernel launched. MS-TCN
    (``frame_ms``): one step on a trial of MT_TRIAL frames, gradients
    against float64, no kernel launched. Returns the launch counts."""
    import copy

    import numpy as np
    import torch

    from stgx_torch.bench import train_throughput
    from stgx_torch.config import build_model
    from stgx_torch.data import SkeletonDirDataset, class_distribution
    from stgx_torch.data.synth import generate
    from stgx_torch.parallel.loop import MODEL_KIND, OptimizerConfig, Trainer
    from stgx_torch.utils import LOSS

    def dataset(sub, trials, length, seed):
        d = os.path.join(data_dir, sub)
        generate(d, skeleton="pku-mmd", num_classes=NUM_CLASSES, in_feat=3, num_train=trials,
                 num_val=0, min_len=length, max_len=length, seed=seed)
        return SkeletonDirDataset(os.path.join(d, "train", "features"),
                                  os.path.join(d, "train", "labels"))

    windows = dataset("win", WIN_TRIALS, WIN_TRIAL, SEED + 36)
    dist = class_distribution(windows, NUM_CLASSES)
    parts = {}
    n = 9
    kernels = {"gcn_core": 2 * n, "gcn_grads": n}
    for tag, config in (("ST-GCN", ST_CONFIG), ("MS-GCN", MG_CONFIG), ("AA-GCN", AA_CONFIG),
                        ("MS-TCN", MT_CONFIG)):
        cfg = load_cfg(config)
        name = cfg["processor"]["model"]
        ds = windows if name != "ms-tcn" else dataset("mstcn", 1, MT_TRIAL, SEED + 37)
        trainer = Trainer(model=build_model(cfg, NUM_CLASSES), kind=MODEL_KIND[name],
                          loss=LOSS[name](dist),
                          opt=OptimizerConfig(learning_rate=cfg["optimizer"]["learning_rate"],
                                              batch_size=WIN_BS, seed=SEED),
                          receptive_field=cfg["arch"]["receptive_field"],
                          bucket=WIN_TRIAL if name != "ms-tcn" else MT_TRIAL)
        chunks = trainer.chunks(*trainer.prepare(*ds[0]))
        check(len(chunks) == 1, f"{tag}: {len(chunks)} chunks, want one")
        if name == "aa-gcn":
            x = window_input(trainer.model, AA_WINDOWS, SEED + 38)
            with torch.inference_mode():
                reset_all_counts()
                y = trainer.model(x)
                torch.cuda.synchronize()
                parts[f"{tag} forward"] = all_counts()
                ms = time_ms(lambda: trainer.model(x), reps=3, warm=1)
            print(f"AA-GCN forward of {AA_WINDOWS} windows: {ms:.3f} ms "
                  f"({AA_WINDOWS / ms * 1e3:.0f} windows/s); launches "
                  f"{json.dumps(parts[f'{tag} forward'])}", flush=True)
            check(sum(parts[f"{tag} forward"].values()) == 0,
                  f"AA-GCN's per-sample graph conv reached a kernel: {parts[f'{tag} forward']}")
            check(y.shape == (AA_WINDOWS, NUM_CLASSES) and bool(torch.isfinite(y).all()),
                  f"AA-GCN forward: {tuple(y.shape)}")
            m64 = copy.deepcopy(trainer.model).double()
            with torch.inference_mode(), plain_ops():
                y64 = m64(x.double())
            del m64
            err, rel = rel_err(y, y64)
            rows = attention_rows(trainer.model, x)
            print(f"AA-GCN forward of {AA_WINDOWS} windows vs all-plain float64: max abs err "
                  f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_AA_FORWARD:g}); attention "
                  f"softmax rows by layer (joint stream, then bone), share with a maximum > "
                  f"0.99: {[round(r[0], 4) for r in rows]}, median score spread (max - min "
                  f"of a row): {[round(r[1], 1) for r in rows]}", flush=True)
            check(rel <= TOL_AA_FORWARD, f"AA-GCN forward: relative error {rel:.3e} from float64")
        want = kernels if name in ("st-gcn", "ms-gcn") else {}
        parts[f"{tag} step"] = window_grad_check(tag, name, trainer, chunks[0],
                                                 float(WIN_BS), want)
        if name != "st-gcn":
            continue
        ce0 = trainer.evaluate(ds)["ce"]
        torch.cuda.synchronize()
        reset_all_counts()
        t0 = time.perf_counter()
        with step_launches() as steps:
            ces = [trainer.train_epoch(ds, epoch)["ce"] for epoch in range(WIN_EPOCHS)]
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        parts[f"{tag} epochs"] = all_counts()
        ce1 = trainer.evaluate(ds)["ce"]
        print(f"{tag}: {WIN_EPOCHS} epochs x {WIN_TRIALS} trials of {WIN_TRIAL} windows in "
              f"{secs:.2f} s ({WIN_EPOCHS * WIN_TRIALS * WIN_TRIAL / secs:.0f} windows/s, "
              f"Adam included); epoch CE {np.round(ces, 4).tolist()}; eval CE {ce0:.4f} -> "
              f"{ce1:.4f}", flush=True)
        check_steps(tag, steps, kernels)
        check(np.isfinite(ces).all() and ce1 < ce0, f"{tag}: CE did not fall")
        smi_now = smi_line()
        for dtype in ("float32", "bfloat16"):
            reset_all_counts()
            rec = train_throughput.main(["--model", "st-gcn", "--trials", str(WIN_TRIAL),
                                         "--dtype", dtype])
            parts[f"{tag} throughput {dtype}"] = all_counts()
            print(f"ST-GCN train step {dtype}, {WIN_TRIAL} windows of 50 frames: p50 "
                  f"{rec['step_ms_p50']:.3f} ms, {rec['frames_per_s']:.0f} windows/s, "
                  f"{rec['model_tflops']:.3f} model TFLOP/s ({100 * rec['peak_share']:.2f} % "
                  f"of peak), HBM share {100 * rec['hbm_share']:.2f} % [{smi_now}]", flush=True)
    return parts


def cli_window_phase(data_dir):
    """``stgx_torch.cli`` for the window models on synthetic trials: ST-GCN
    trains two epochs, resumes from epoch-0, tests on ``final`` and
    benchmarks (``cli_frame_phase``; every train step 18 gcn_core and 9
    gcn_grads), its ``latency.csv`` with the int8 columns filled; MS-GCN
    trains one epoch and tests at full width, AA-GCN and MS-TCN at full
    width on fewer, shorter trials. Returns the launch counts."""
    n = 9
    want = {"gcn_core": 2 * n, "gcn_grads": n}
    parts = {}
    st_dir = os.path.join(data_dir, "st")
    reset_all_counts()
    for k, v in cli_frame_phase(st_dir, ST_CONFIG, "st-gcn", want, SEED + 40)[0].items():
        parts[f"st-gcn {k}"] = v
    # cli_frame_phase counts the graph-conv kernels; the benchmark's int8
    # rows launched the products
    parts["st-gcn benchmark int8"] = {k: n for k, n in all_counts().items()
                                      if k in _int8_wrappers()}
    header, row = read_csv(os.path.join(st_dir, "st-gcn", "latency.csv"))
    cols = dict(zip(header, row))
    print(f"CLI benchmark st-gcn latency.csv: {json.dumps(cols)}", flush=True)
    check(all(float(cols[k]) > 0 for k in header), f"CLI benchmark st-gcn: {cols}")
    for tag, config, trials, lengths, seed in (
            ("ms-gcn", MG_CONFIG, CLI_TRIALS, CLI_LEN, SEED + 41),
            ("aa-gcn", AA_CONFIG, CLI_SG_TRIALS, CLI_SG_LEN, SEED + 42),
            ("ms-tcn", MT_CONFIG, CLI_SG_TRIALS, CLI_SG_LEN, SEED + 43)):
        sub = os.path.join(data_dir, tag)
        out = os.path.join(sub, "out")
        base = cli_data(sub, trials, lengths, seed) + ["optimizer.epochs=1",
                                                       f"processor.out={out}"]
        reset_all_counts()
        with step_launches() as steps:
            run_cli("train", config, *base)
        parts[f"{tag} train"] = all_counts()
        check_steps(f"cli {tag} train", steps, want if tag == "ms-gcn" else {})
        reset_all_counts()
        run_cli("test", config, *base, f"processor.checkpoint={out}/final")
        parts[f"{tag} test"] = all_counts()
        curve = read_csv(os.path.join(out, "train-validation-curve.csv"))
        top1 = float(read_csv(os.path.join(out, "accuracy.csv"))[1][0])
        check(top1 == float(curve[-1][7]) and os.path.exists(
            os.path.join(out, "segmentation-0.csv")), f"cli {tag} test: top1 {top1}, {curve}")
    return parts


# -------------------------------------------------------------- main path


def main_path(cfg):
    """Drive the serving path once with the counters at zero; return the
    outputs and the counts of each part."""
    import numpy as np
    import torch

    from stgx_torch.bench import serving
    from stgx_torch.config import build_model
    from stgx_torch.ops.rt_fused import set_rt_fused

    model = build_model(cfg, NUM_CLASSES)
    set_rt_fused(False)
    x = torch.tensor(np.random.default_rng(SEED).normal(
        size=(N_BATCH, L_BATCH, model.num_joints, model.in_feat)),
        dtype=torch.float32, device="cuda")

    reset_counts()
    c0 = counts()
    with torch.inference_mode():
        y_unfused = model(x)
        torch.cuda.synchronize()
        c1 = counts()
        set_rt_fused(True)
        y_fused = model(x)
        torch.cuda.synchronize()
        set_rt_fused(False)
        c2 = counts()
        records = serving.main(["--config", CONFIG, "--batches", f"1,{B_STREAM}",
                                "--frames", str(L_STREAM)])
        c3 = counts()
    parts = {"unfused": diff(c1, c0), "fused": diff(c2, c1), "serving": diff(c3, c2)}
    return model, x, y_unfused, y_fused, records, parts, c3


def run() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "stgx_torch")):
        print("chip_smoke: run it from the repository (stgx_torch/ is missing)",
              file=sys.stderr)
        return 2
    os.chdir(here)
    sys.path.insert(0, here)

    import numpy as np

    from stgx_torch import strict_numerics
    from stgx_torch.bench.serving import WARMUP_STEPS, measure_step_latency
    from stgx_torch.config import build_model, load_config
    from stgx_torch.kernels import build
    from stgx_torch.models.rtstgcn import stream_sequence

    strict_numerics()  # TF32 off for matmul and cuDNN; cuDNN deterministic

    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(library {build.source_hash()})", flush=True)
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    cfg = load_config(CONFIG)
    arch = cfg["arch"]["rt-st-gcn"]
    layers = list(zip(arch["in_ch"], arch["out_ch"], arch["stride"]))

    # each kernel against its plain version, at the main paths' shapes
    t_phase = time.perf_counter()
    shape_model = build_model(cfg, NUM_CLASSES)
    recs = kernel_phase(shape_model, layers)
    phase_done("forward kernels vs plain", t_phase)
    t_phase = time.perf_counter()
    recs.update(backward_kernel_phase(shape_model, layers))
    phase_done("backward kernels vs plain", t_phase)

    # the serving path, with the launch counters at zero
    t_phase = time.perf_counter()
    model, x, y_unfused, y_fused, records, parts, launched = main_path(cfg)
    n = len(layers)
    steps = 2 * (WARMUP_STEPS + L_STREAM)  # serving ran B = 1 and B = B_STREAM
    none = {k: 0 for k in counts()}
    print(f"launches on the serving path: {json.dumps(parts)}", flush=True)
    check(parts["unfused"] == {**none, "gcn_core": n, "window_sum": n},
          f"unfused batch forward launched {parts['unfused']}")
    check(parts["fused"] == {**none, "rt_fused": n},
          f"fused batch forward launched {parts['fused']}")
    check(parts["serving"] == {**none, "gcn_core": n * steps},
          f"serving launched {parts['serving']}, want {n * steps} gcn_core")

    before = counts()
    with torch.inference_mode(), plain_ops():
        y_plain = model(x)
    torch.cuda.synchronize()
    check(counts() == before, "the plain reference run launched a kernel")
    check(y_unfused.shape == (N_BATCH, L_BATCH, NUM_CLASSES), f"shape {y_unfused.shape}")
    for name, y in (("unfused", y_unfused), ("fused", y_fused)):
        check(bool(torch.isfinite(y).all()), f"batch form {name}: non-finite logits")
        err, rel = rel_err(y, y_plain)
        print(f"batch form {name} vs all-plain: max abs err {err:.3e} "
              f"(relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
        check(rel <= TOL_MODEL, f"batch form {name}: relative error {rel:.3e}")

    from stgx_torch.ops.rt_fused import set_rt_fused

    with torch.inference_mode():
        for fused in (False, True):
            set_rt_fused(fused)
            ms = time_ms(lambda: model(x), reps=5, warm=1)
            print(f"batch form {'fused' if fused else 'unfused'} forward, "
                  f"N={N_BATCH} x L={L_BATCH}, fp32: {ms:.3f} ms "
                  f"({N_BATCH * L_BATCH / ms * 1e3:.0f} frames/s)", flush=True)
        set_rt_fused(False)
        with plain_ops():
            ms = time_ms(lambda: model(x), reps=5, warm=1)
        print(f"batch form all-plain forward: {ms:.3f} ms", flush=True)

    # the streaming cell against the all-plain cell
    step_ms, logits = measure_step_latency(model, B_STREAM, L_STREAM)
    with plain_ops():
        plain_step_ms, logits_plain = measure_step_latency(model, B_STREAM, L_STREAM)
    check(bool(torch.isfinite(logits).all()), "streaming cell: non-finite logits")
    err, rel = rel_err(logits, logits_plain)
    print(f"streaming cell B={B_STREAM} x {L_STREAM} frames vs all-plain: max abs err "
          f"{err:.3e} (relative {rel:.3e}, tolerance {TOL_MODEL:g}); step p50 "
          f"{np.percentile(step_ms, 50):.4f} ms, all-plain p50 "
          f"{np.percentile(plain_step_ms, 50):.4f} ms", flush=True)
    check(rel <= TOL_MODEL, f"streaming cell: relative error {rel:.3e}")
    for rec in records:
        print(f"serving B={rec['streams']}: step p50 {rec['step_ms_p50']:.4f} ms, "
              f"p99 {rec['step_ms_p99']:.4f} ms", flush=True)

    # FIFO == batch under LayerNorm
    cfg_ln = load_config(CONFIG, ["arch.normalization=LayerNorm"])
    ln = build_model(cfg_ln, NUM_CLASSES)
    x_ln = x[:2, :128]
    with torch.inference_mode():
        y_batch = ln(x_ln)
        y_stream, _ = stream_sequence(ln, x_ln)
    err, rel = rel_err(y_stream, y_batch)
    print(f"LayerNorm FIFO == batch, 2 x 128 frames: max abs err {err:.3e} "
          f"(relative {rel:.3e}, tolerance {TOL_MODEL:g})", flush=True)
    check(rel <= TOL_MODEL, f"FIFO != batch under LayerNorm: {rel:.3e}")
    del ln, model, shape_model
    phase_done("serving path", t_phase)

    # the training path, with the launch counters at zero for each form.
    # Every layer's input needs a gradient (fcn_in comes before layer 0),
    # so the unfused backward launches gcn_core for gx in every layer; a
    # layer whose input needed none would skip that launch.
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        trained = training_phase(cfg, data_dir)
    phase_done("training path", t_phase)
    for part in trained.values():
        launched = {k: launched[k] + part[k] for k in launched}
    check(all(v > 0 for k, v in launched.items() if not k.startswith("temporal_shift")),
          f"an RT-ST-GCN kernel never launched: {launched}")

    t_phase = time.perf_counter()
    throughput = throughput_phase()
    phase_done("train throughput", t_phase)
    smi_now = smi_line()
    for rec in throughput:
        print(f"train step {rec['dtype']} {'fused' if rec['fused'] else 'unfused'}, "
              f"{rec['trials']} x {rec['frames']} frames: p50 {rec['step_ms_p50']:.3f} ms, "
              f"{rec['frames_per_s']:.0f} frames/s, {rec['model_tflops']:.3f} model "
              f"TFLOP/s ({100 * rec['peak_share']:.2f} % of peak) [{smi_now}]", flush=True)

    # RT-ST-GCN at Gamma = 69: window_sum at its shapes, then the batch
    # forward and a train step with the counters at zero
    t_phase = time.perf_counter()
    gamma69_kernel_phase(recs, layers)
    cfg69 = load_config(CONFIG_69)
    for part in gamma69_phase(cfg69).values():
        launched = {k: launched[k] + part[k] for k in launched}
    g69_throughput = gamma69_throughput_phase(cfg69)
    smi_now = smi_line()
    for rec in g69_throughput:
        prof = rec["profile"]
        print(f"Gamma=69 train step {rec['dtype']}, {rec['trials']} x {rec['frames']} frames: "
              f"p50 {rec['step_ms_p50']:.3f} ms, {rec['frames_per_s']:.0f} frames/s, device "
              f"busy {100 * prof['busy_share']:.1f} %, window_sum "
              f"{100 * rec['window_share']:.1f} % of device time [{smi_now}]", flush=True)
    phase_done("Gamma=69", t_phase)

    # Shift-GCN: its kernel against the plain version, then its serving and
    # training paths, each with the launch counters at zero
    sg_cfg = load_config(SG_CONFIG)
    t_phase = time.perf_counter()
    recs.update(shift_kernel_phase(shift_shapes(sg_cfg)))
    phase_done("temporal_shift vs plain", t_phase)
    t_phase = time.perf_counter()
    sg_parts = shift_serving_phase(sg_cfg)
    phase_done("Shift-GCN serving path", t_phase)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        sg_parts["train"] = shift_training_phase(sg_cfg, data_dir)
    phase_done("Shift-GCN training path", t_phase)
    for part in sg_parts.values():
        launched = {k: launched[k] + part[k] for k in launched}
    check(all(v > 0 for v in launched.values()), f"a kernel never launched: {launched}")
    t_phase = time.perf_counter()
    sg_throughput = shift_throughput_phase()
    phase_done("Shift-GCN train throughput", t_phase)
    smi_now = smi_line()
    for rec in sg_throughput:
        print(f"Shift-GCN train step {rec['dtype']}, {rec['trials']} windows of "
              f"{rec['frames']} frames: p50 {rec['step_ms_p50']:.3f} ms, "
              f"{rec['frames_per_s']:.0f} windows/s [{smi_now}]", flush=True)

    # CoST-GCN: the batch form, the serving cell, the drift check, the
    # training path and train throughput, each with the counters at zero
    co_launched = {k: 0 for k in launched}
    t_phase = time.perf_counter()
    temporal_conv_phase()
    phase_done("CoST-GCN temporal conv", t_phase)
    for name, phase in (("CoST-GCN batch form", costgcn_forward_phase),
                        ("CoST-GCN serving", costgcn_streaming_phase),
                        ("stream drift", drift_phase)):
        t_phase = time.perf_counter()
        for key, part in phase().items():
            launched = {k: launched[k] + part[k] for k in launched}
            if "rt-st-gcn" not in key:  # the drift check's RT cell
                co_launched = {k: co_launched[k] + part[k] for k in co_launched}
        phase_done(name, t_phase)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        for part in costgcn_training_phase(data_dir).values():
            launched = {k: launched[k] + part[k] for k in launched}
            co_launched = {k: co_launched[k] + part[k] for k in co_launched}
    phase_done("CoST-GCN training path", t_phase)
    t_phase = time.perf_counter()
    co_throughput = costgcn_throughput_phase()
    phase_done("CoST-GCN train throughput", t_phase)
    smi_now = smi_line()
    for rec in co_throughput:
        prof = rec["profile"]
        print(f"CoST-GCN train step {rec['dtype']}, {rec['trials']} x {rec['frames']} frames: "
              f"p50 {rec['step_ms_p50']:.3f} ms, {rec['frames_per_s']:.0f} frames/s, "
              f"{rec['model_tflops']:.3f} model TFLOP/s ({100 * rec['peak_share']:.2f} % of "
              f"peak), HBM share {100 * rec['hbm_share']:.2f} %, device busy "
              f"{100 * prof['busy_share']:.1f} %, {prof['launches_per_step']:.0f} launches a "
              f"step, temporal convs {100 * rec['conv_share']:.1f} % of device time "
              f"[{smi_now}]", flush=True)

    # the entry points a user runs: the CLI for RT-ST-GCN9 (unfused and
    # fused), at Gamma = 69, for Shift-GCN and for CoST-GCN, each with the
    # counters at zero; remat; the headline's functions
    for name, phase in (("CLI RT-ST-GCN9", cli_rt_phase), ("CLI Gamma=69", cli_gamma69_phase),
                        ("CLI Shift-GCN", cli_shift_phase), ("CLI CoST-GCN", cli_costgcn_phase)):
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as data_dir:
            for part in phase(data_dir).values():
                launched = {k: launched[k] + part[k] for k in launched}
                if phase is cli_costgcn_phase:
                    co_launched = {k: co_launched[k] + part[k] for k in co_launched}
        phase_done(name, t_phase)
    print(f"launches on the CoST-GCN paths (batch form, serving, drift, training, CLI): "
          f"{json.dumps(co_launched)}", flush=True)
    check(co_launched["gcn_core"] > 0 and co_launched["gcn_grads"] > 0
          and sum(co_launched.values()) == co_launched["gcn_core"] + co_launched["gcn_grads"],
          f"the CoST-GCN paths launched {co_launched}")
    t_phase = time.perf_counter()
    remat_phase()
    phase_done("remat", t_phase)
    t_phase = time.perf_counter()
    headline_phase(smi)
    phase_done("headline", t_phase)

    # the int8 cells: their two products against the plain versions, then
    # the cells, serving, quant_ab and the CLI, each with the counters at zero
    t_phase = time.perf_counter()
    int8_kernel_phase(recs)
    phase_done("int8 products vs plain", t_phase)
    int8_launched = {k: 0 for k in _int8_wrappers()}
    reset_all_counts()
    ROUTES_SEEN.clear()  # from here: the int8 paths' launches by route
    t_phase = time.perf_counter()
    int8_parts = int8_cell_phase()
    phase_done("int8 cells", t_phase)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as data_dir:
        int8_parts.update(int8_serving_phase(data_dir))
    phase_done("int8 entry points", t_phase)
    for part in int8_parts.values():
        int8_launched = {k: int8_launched[k] + part[k] for k in int8_launched}
    reset_all_counts()
    print(f"launches on the int8 paths (calibration, cells, drift, serving, quant_ab, CLI): "
          f"{json.dumps(int8_launched)}; by route {json.dumps(ROUTES_SEEN)}", flush=True)
    check(all(v > 0 for v in int8_launched.values()),
          f"an int8 product never launched: {int8_launched}")

    # the window models at their as_is widths: ST-GCN's batch form, window
    # cell and int8 window cell, the four families' training paths and
    # their CLI, each with the counters at zero
    win_launched = {k: 0 for k in all_counts()}
    t_phase = time.perf_counter()
    window_kernel_phase(recs)
    phase_done("gcn_core and gcn_grads at ST-GCN's shapes", t_phase)
    for name, phase in (("ST-GCN batch form", stgcn_forward_phase),
                        ("ST-GCN window cell", window_serving_phase),
                        ("int8 ST-GCN window cell", window_int8_phase),
                        ("window models training", window_training_phase),
                        ("CLI window models", cli_window_phase)):
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory() as data_dir:
            args = (data_dir,) if phase in (window_training_phase, cli_window_phase) else ()
            for part in phase(*args).values():
                win_launched = {k: win_launched[k] + part.get(k, 0) for k in win_launched}
        phase_done(name, t_phase)
    reset_all_counts()
    print(f"launches on the window models' paths (batch form, window cells, int8 window "
          f"cell, training, CLI): {json.dumps(win_launched)}", flush=True)
    used = ("gcn_core", "gcn_grads", "int8_gemm", "w8_gemm")
    check(all(win_launched[k] > 0 for k in used)
          and all(v == 0 for k, v in win_launched.items() if k not in used),
          f"the window models' paths launched {win_launched}")
    launched = {k: launched[k] + win_launched[k] for k in launched}
    int8_launched = {k: int8_launched[k] + win_launched[k] for k in int8_launched}

    # the kernels line
    meta = {
        "gcn_core": ("stgx_torch/csrc/gcn_core.cu", "stgx/ops/pallas_gcn.py:76"),
        "window_sum": ("stgx_torch/csrc/window_sum.cu", "stgx/ops/pallas_acc.py:60"),
        "rt_fused": ("stgx_torch/csrc/rt_fused.cu", "stgx/ops/rt_fused.py:122"),
        "gcn_grads": ("stgx_torch/csrc/gcn_grads.cu", "stgx/ops/pallas_gcn.py:137"),
        "rt_fused_bwd": ("stgx_torch/csrc/rt_fused_bwd.cu", "stgx/ops/rt_fused.py:217"),
        "temporal_shift": ("stgx_torch/csrc/temporal_shift.cu", "stgx/ops/shift.py:96"),
        # no TPU kernel: the JAX VJP of the shift (_ts_bwd) is XLA
        "temporal_shift_bwd": ("stgx_torch/csrc/temporal_shift.cu", "stgx/ops/shift.py:149"),
        # no TPU kernels: the int8 cells' XLA products
        "int8_gemm": ("stgx_torch/csrc/int8_gemm_tma.cuh",
                      "stgx/bench/quant.py:199 (XLA int8 dot_general)"),
        "w8_gemm": ("stgx_torch/csrc/int8_gemm_tma.cuh",
                    "stgx/bench/quant.py:194 (XLA w8 dot_general)"),
    }
    launched = {**launched, **int8_launched}
    for name in _int8_wrappers():
        recs[name]["launches_by_route"] = {key.split(".")[1]: n for key, n in ROUTES_SEEN.items()
                                           if key.startswith(name)}
    kernels = []
    for name, (source, replaces) in meta.items():
        r = recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launched[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["_tb"] >= r["_to"] else "operations",
            "library_ms": r["library_ms"],
            **{k: v for k, v in r.items() if not k.startswith("_") and k not in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms")},
        })
    print("kernel times are summed over the 9 layers at fp32: the forward kernels at "
          f"one batch forward's shapes (N={N_BATCH}, L={L_BATCH}), the backward ones at "
          f"one train step's (N={N_TRAIN}, L={L_TRAIN}); temporal_shift over the 20 "
          f"launches of one Shift-GCN forward of {SG_WINDOWS} windows; launches are those "
          f"of the serving, training and CLI paths of RT-ST-GCN, Shift-GCN and CoST-GCN; "
          f"int8_gemm and w8_gemm over one step of RT9's and CoST9's int8 cells at "
          f"B={B_STREAM} with int8 codes / fp32 operands (library_ms: torch._int_mm at the "
          f"sites it takes, beside the kernel's library_kernel_ms there; torch.matmul on an "
          f"fp32 weight for w8; fp32_in_ms (int8_gemm) / bf16_in_ms / taps_ms: the operand "
          f"in fp32 or bf16 (quantized inside int8_gemm, widened in w8_gemm; bf16 at the "
          f"sites the tma route takes, all but fcn_in) and the tcn sites' FIFO taps; "
          f"w8's bound: its two TF32 passes; large: the shapes of LARGE_INT8), their "
          f"launches those of the int8 paths, the int8 ST-GCN window cell's and the CLI's "
          f"included (launches_by_route: tma / staged); gcn_core and gcn_grads launches "
          f"include the window models' paths, and window_*: their times summed over "
          f"ST-GCN's 9 layers at {ST_WINDOWS} windows (gcn_core) and {WIN_TRIAL} windows "
          f"(gcn_grads); "
          f"gcn_core and gcn_grads "
          f"also give their fp32 route's bound and their bf16 times and bound, rt_fused "
          f"and rt_fused_bwd the port's unfused kernels for the same function "
          f"(unfused_ms) and their bf16 times and bound",
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(run())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
