#!/usr/bin/env python3
"""Smoke run of dgp_tpu_torch (the PyTorch/CUDA port) on one NVIDIA GPU.

Phases, each printing its results (and its seconds) as one JSON line:

  device    require CUDA; print the card's name and power limit as
            `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`
            gives them.
  build     build the hand-written kernels from dgp_tpu_torch/csrc with nvcc
            for sm_90a (one nvcc per source, in parallel); print the build
            seconds, ptxas's registers, stack and spill counts, and the
            launch plan of all four kernels at m1 = 26, d = 2 (points per
            thread block, its shared bytes, blocks and warps per SM), and
            at two rows per lane (m1 = 41 and 64, d = 2) with the registers
            and spills of those instantiations; K5's at D = 2; and K6's
            at d = 1 (kriging m1 = 51, linked 50).
  kernels   run each kernel and its plain PyTorch version on the card at the
            shapes of the main path -- K1 at the M-step's (G=2, 26, 2, 2000)
            with 2 length lanes and the nugget lane; K2 at (26, 2, 2000) with
            K=9, dl=1 and dl=d; K3 at (26, 1, 2000); K4 at (26, 2, 2000) and
            with a leading axis of 9 candidates; and the gp phase's own
            calls, K1 without a node axis at (26, 1, 2000) with one length
            lane and the nugget lane, and K4 at (26, 1, 2000), on the gp's
            Vecchia ordering; and the lik_vecchia phase's, on its data: K3
            on a layer-2 node's input at (26, 2, 2000), K2 under each of
            its two layer-2 nodes, and K1 for its M-step group at (G=3, 26,
            2, 2000) -- for sexp and Matern-2.5,
            float64 and float32, with sentinel lanes; check them against
            each other; time kernel, plain version and the batched
            torch.linalg.cholesky_ex of the same blocks (CUDA events around
            10 calls back to back, median of 20; the kernel and the library
            call also as one call alone) at those shapes (K2 at dl=1 only,
            K4 also with its 9 candidates), and compute each kernel's least
            time on the card.  Then the edges of the warp-per-block mapping
            of all four kernels on well-conditioned random blocks: a full
            warp (m1 = 32) at a ragged n (2001), a two-row block at an n
            below one thread block's points, d = 5 (K1 with 5 length lanes;
            K3 and K4 without sentinel lanes), G = 1 (K1), K = 1 and dl = 0
            (K2), K2 at d = 3 with dl = 1 and sentinel lanes, K4 with 9
            candidates sharing one target and diagonal or each with its own;
            the instantiation with two rows per lane at the edges of its
            two panels, m1 = 33 (panel 2 of one row), 41, 48, 63 and 64
            (all four kernels, K2 also at d = 3, K4 also with 3 candidates
            of their own), K1 with 12 length lanes (d = 12, two passes of
            the gradient stage; also isotropic at d = 12 and m1 = 41, and
            12 lanes over 13 dims at m1 = 33), with 16 and 17 (passes ending
            with the nugget lane alone and with a length lane), at m1 = 64
            with 9 and 12 and at m1 = 41 with 24; and blocks with a
            non-positive pivot at m1 = 26 (also with 12 length lanes), 33
            (panel 1) and 64 (rows 0 and 32: both panels), which must come
            out NaN where the plain version's do.  The linked phase's
            calls too, on its data: K1 for its gp, K3 and K2 for its DGP;
            and the large_n phase's, at n = 1e5 on its data with the IVF
            neighbours: K1 for its DGP's M-step group (2, 26, 2, n), K2 with
            9 candidates, K3 and K4 for its layer-2 node (26, 2, n).
            350 comparisons in all (the phase prints the count).  Each
            kernel at m1 = 41, 48, 63 and 64, K1 with 12 and 16 length
            lanes and the four n = 1e5 cases are also timed (kernel, plain
            version, library call, bound).
  linked_dense
            K5 (the dense linked moments) against its plain version, float64
            and float32, sexp and matern2.5: M = 1 at n = 37, D = 1; M = 15
            at n = 1999, D = 3 with row weights and a zero-variance dim; M =
            250 at n = 2000, D = 2 (the lgp_n2000.predict cell's dense call)
            without and with them; then timed at the cell's shape (kernel,
            the plain version in its LINK_BUDGET batches, bound).
  vecchia_pred
            K6 (a Vecchia node's prediction in one launch) against its plain
            versions, float64 and float32: kriging (matern2.5, k = 50, so
            m1 = 51) and linked (sexp, k = 50, Dw = 1), each at M = 250 on n
            = 2000 training points (the lgp_n2000.predict cell's calls) and
            at M = 8000 on n = 1e5, also with -1 lanes and a global input;
            the gate's shared bytes against the launch plan; then each timed
            (CUDA events over calls back to back and one call alone, the
            kernel's device time under torch.profiler, host per call, the
            plain version's the same, and the least time from
            benchmark/counts/ops.py's counts).
  main      the port's serving path at the configuration of bench.py: a
            2-layer Vecchia DGP, n=2000, m=25, hyper-parameters from
            dgp_tpu_torch/data/vecchia_si_n2000.json; dgp(...), then
            emulator(m.estimate(), N=5), predict on 1000 points at m=50 and
            then on 20000 points.  Fails unless K2 and K3 were launched by
            this path and the RMSE against the noiseless truth is finite and
            at most twice the JAX package's figure in the JSON.
  design    one sequential-design step at the same configuration, under the
            protocol of dgp_tpu_torch/data/design_n2000.json (written by
            tools/make_torch_design_params.py with the JAX package): dgp(...)
            at the JSON's hyper-parameters, emulator(N=5); ALM, MICE and
            VIGF (obj=the dgp) at m=50 on 1000 candidates of [-1, 1], each
            also on a CPU copy of the same imputations
            (emulator.from_imputations(..., device='cpu')); the 40
            candidates with the highest ALM scores, with func plus noise of
            sd 0.05, added by update_xy (n = 2040); train(N=16,
            chunk_size=16), emulator(N=5), predict on the 1000 test points,
            loo at m=30 on the 2040 points, 50 draws per imputation by
            method='sampling' and full_layer=True on the 1000 points;
            write, then read on the card and on the CPU; summary of the dgp
            and the emulator.  Fails unless K2 and K3 were launched by
            update_xy and K1, K2 and K3 by the retraining, no plain version
            ran, everything is finite, every score is within rtol 1e-9 of
            the CPU copy's (relative to the largest score where a score is
            below a thousandth of it) with the same picks, the RMSE and the
            LOO RMSE (against the observed outputs) are at most twice the
            JAX package's medians over the protocol's seeds, the sampling
            mean is within 4 Monte-Carlo standard errors of the mean_var
            mean at 99% of the points, and the predictions after read are
            the same bit for bit on the card and within rtol 1e-9 on the
            CPU.
  train     SEM training of the same configuration from bench.py's starting
            hyper-parameters (length 0.5, nugget 1e-4): train(N=48) as
            warm-up, a timed train(N=152) (200 iterations, the protocol
            behind the JSON), then emulator(m.estimate(), N=5) and predict on
            1000 points at m=50.  Fails unless K1, K2 and K3 were launched,
            everything is finite and the RMSE is at most twice the JSON's.
  nodewise  the same data with node-wise ESS (block=False): construction and
            4 SEM iterations.  Fails unless K4 was launched and the results
            are finite.
  gp        the single-GP emulator on the same n=2000 data, under the
            protocol of dgp_tpu_torch/data/gp_n2000.json (written by
            tools/make_torch_gp_params.py with the JAX package): a dense gp
            (sexp, scale and nugget estimated), train(), predict on the 1000
            test points (RMSE) and on 20000 points (points per second),
            loo(), ALM/MICE/VIGF on 1000 candidates; then to_vecchia(m=25),
            train() (through K1), log_likelihood_func() (through K4) and
            predict at m=50.  Fails unless K1 and K4 were launched by the
            Vecchia steps, everything is finite, both RMSEs are at most
            twice the JAX package's, the trained hyper-parameters (dense and
            Vecchia) are within rtol 1e-6 of the JAX package's, the Vecchia
            log-likelihood within rtol 1e-9 of its figure, and ALM/MICE/VIGF
            pick the JAX package's candidates.
  ref       bench.py's 2-layer Vecchia DGP with the 'ref' prior on both
            nodes: construction and 4 SEM iterations.  The 'ref' layer's ESS
            candidates go through K4 (no angle views, so K2 is not
            launched); fails unless K1, K3 and K4 were launched, K2 was not,
            and the results are finite.
  gate      the kernel gate (`cuda_vecchia.use_kernel`): its shared-memory
            formula against `launch_plan`'s figure on the card for all four
            kernels, at one row per lane and at two (m1 = 33, 48, 64: the
            last d inside and a launch plan that fails one d beyond, where
            the gate says no); then bench.py's Vecchia DGP at m=64 (m1 = 65,
            outside the kernels' bound), which runs through the large-block
            route of vecchia.core (the JAX package's XLA branch):
            construction, 4 SEM iterations, emulator(N=2) and predict on
            1000 points, with route calls for K1, K3 and K4, no kernel
            launched but K6 (the prediction's blocks at m = 50 are inside
            its bound) and no plain version run, and the upper log-likelihood
            of the trained state within rtol 1e-9 of a CPU engine carrying
            the same state; a wrapper called directly at m1 = 65 must still
            raise NotImplementedError on the card; the route's log-likelihood,
            conditional weights and M-step objective are timed at n=2000 for
            m = 64 and 100.  Then the same model at m=40 (m1 = 41, two rows
            per lane): construction, 4 SEM iterations (their seconds per
            iteration printed), emulator(N=2) and predict.  Fails unless K1, K2 and K3 were launched, no plain
            version ran, the route was not taken, the angle evaluator
            applies and the upper log-likelihood of the trained state
            agrees with the same call on a CPU engine to rtol 1e-9.  Last a
            Vecchia gp on 12 inputs with 12 lengthscales (n=300), trained on
            the card (K1 takes its 12 length lanes) and on the CPU: the
            parameters agree to rtol 1e-6.
  parallel  O7: the split over a mesh -- every visible card, or on a
            machine with one card two shares of it (the mesh that
            model_mesh('cuda') gives must name each card once) -- against
            the one-device calls.  ptrain(N=16) of the main path's model
            (n=2000, m=25, the JSON's hyper-parameters, built with
            device='cuda') and of large_n's bench.py n = 1e5 model, each
            against a twin's train(N=16) from the same nb_seed: the
            hyper-parameter paths, latents and R^2 equal bit for bit after
            2 more iterations under torch.profiler, in which each split
            kernel (K1, K2, K3) is launched once per share where train
            launches it once, with as many host reads (device-to-host
            copies) per SEM iteration; seconds, syncs and launches per card
            are printed.  Then the p* methods split their row chunks (whole
            chunks of 2048 queries a share): emulator(N=5)'s ppredict
            on 20000 points at m=50, ploo at m=30 and pmetric (ALM on 1000
            candidates) equal to predict, loo and metric bit for bit; the gp
            phase's dense gp, ppredict on 20000 points and pmetric (MICE);
            the linked phase's system at its first seed, lgp.ppredict on 200
            points; multistart on Branin from 64 starts, one batched L-BFGS
            on the card, which must raise no RuntimeWarning (the scipy path)
            and find a value below 0.5.
  linked    linked emulation at the main path's width, under the protocol
            of dgp_tpu_torch/data/linked_n2000.json (written by
            tools/make_torch_params.py linked with the JAX package): the
            model_linking notebook's GP -> DGP system, f2(f1(x)) = `func`.
            Model 1, a Vecchia gp (Matern-2.5, m=25) on 2000 points of f1,
            trained on the card (K1); model 2, the main path's DGP on 2000
            points of f2 at the JAX package's trained hyper-parameters;
            container(m1.export()), container(m2.estimate()) (50 burn-in
            sweeps: K3, K2), lgp(N=10) and predict on 1000 and 20000 points
            of [-1, 1] at m=50, at lgp seeds 1, 2, 3.  Fails unless the gp's
            trained parameters are within rtol 1e-6 of the JAX package's,
            K1, K2 and K3 were launched with no plain call, and the median
            RMSE against func is at most twice the JAX package's median
            under the same protocol.
  lik_vecchia  the likelihood slice at full width, under the protocol of
            dgp_tpu_torch/data/lik_n2000.json (written by
            tools/make_torch_lik_params.py with the JAX package): bench.py's
            function at n=2000 with noise whose sd depends on x, a 3-layer
            Vecchia DGP (m=25) [1 GP] -> [2 GPs, global input, scale
            estimated] -> [Hetero()], train(N=100), emulator(N=5), predict on
            1000 and on 20000 points at m=50, nllik on 2000 held-out points;
            then training, emulator and nllik again at the protocol's other
            two training seeds.  Fails unless K1, K2 and K3 were launched,
            the Hetero mean was drawn through `post_het_vecch`, everything
            is finite, the RMSEs of the predicted mean and of the predicted
            noise variance are at most twice the JAX package's, and the
            median test nllik over the three training seeds is at most 0.05
            nat above the JAX package's median over the same seeds.
  large_n   the large-n path, under the protocol of
            dgp_tpu_torch/data/large_n1e5.json (written by
            tools/make_torch_large_params.py with the JAX package), on
            bench.py's n = 1e5 draw (seed 7): (1) the IVF search of the gp's
            scaled, ordered input on the card against the exact search on
            the card, both timed: ordered recall, prediction recall (20000
            queries, m = 50), two builds equal, and the stored rows of the
            JAX package's IVF neighbours; (2) a Vecchia gp (m = 25, the
            gp_n2000.json protocol at n = 1e5; IVF from n >= 50000):
            train() (K1), log_likelihood_func() (K4), predict on 1000 and
            20000 points at m = 50; (3) bench.py's _large_n and
            _large_n_predict legs: the 2-layer Vecchia DGP (m = 25,
            check_rep=False), train(N=32) then a timed train(N=16) (chunks
            of 16), emulator(N=5), predict on 1000 and 20000 points at
            m = 25, the same 1000 points through the exact search on the
            same imputations, and the IVF search of the trained layer-2
            node's input (latent, x) against the exact one.  Fails unless
            every recall is at least 0.95, the builds are equal, 99.9% of
            the stored rows equal the JAX package's, every node took
            'approx', the gp's trained parameters are within rtol 1e-6 of
            the JAX package's and its RMSE at most twice its, K1-K3 were
            launched by the DGP's SEM and K1, K4 by the gp, the DGP's RMSE
            is at most 0.0295 (the main path's gate) and its IVF and exact
            predictions differ by less than 0.02 on average.
  lik_rows  the parity rows with a likelihood node whose data is made from
            a seed (tools/parity.py:109-210, data from tools/parity_data.py),
            each at its full protocol and against its gate there with the
            anchors of REF_ANCHORS.json: `poisson` (n=90, train 500, N=10),
            `negbin` (n=180, train 500, N=50; three SEM seeds, the median
            of each figure against its gate), `zip` (n=160, train 500,
            N=10).
  dense_dgp the parity row `2d` (tools/parity.py): a 4-layer dense sexp DGP
            of 7 nodes, n=24, widths 2/2/2/1 with global connections;
            train(N=500), emulator(N=50) and predict on the 100 diagonal
            points.  Fails unless the RMSE against the truth is at most the
            parity gate 0.0612 (1.15x dgpsi's 0.0532).
            It and the five runs of `lik_rows` are dense and bound by the
            host, so they go side by side, one worker process each on the
            one card; `dense_dgp` prints its line first.

Then it prints the kernel summary line and, last, the device line.  Any
failed phase exits non-zero.  Usage, from the repository root:

    python3 chip_smoke.py
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_TRAIN = 2000
M_TRAIN = 25
# float64, per value: |kernel - plain| <= ATOL + RTOL |plain|.  Checked on
# well-conditioned blocks at the main path's shapes (nugget 0.1, so every
# block's condition number is below ~300).
RTOL64, ATOL64 = 1e-9, 1e-12
# float64 on the main path's own blocks (nugget 1e-4): condition numbers
# reach ~1e5, so two correct Cholesky orders (the kernel's column order and
# the library's blocked one) differ by ~cond * eps ~ 1e-11 relative to the
# largest value, and near-zero values cannot meet a per-value bound.  Here
# the bound is normwise: max |kernel - plain| <= RTOL64 * max |plain|.
NUGGET_WELL, NUGGET_BENCH = 1e-1, 1e-4
# float32, K2: relative error of the summed log-likelihood against the
# float64 plain version (the repo's own float32 bound, tests/test_pallas.py)
REL_LL32 = 5e-3
# float32, per-point values, K3's weights and K1's gradients: the blocks at
# this n are ill-conditioned (neighbours 1e-3 apart, diagonal 1 + 1e-4 +
# 3e-5), so float32 errors of order 1e-2 relative are inherent to any
# factorisation.  The kernel must be no less accurate than the plain
# PyTorch version in float32: max |kernel32 - plain64| <= F32_FACTOR *
# max |plain32 - plain64| + F32_FLOOR * max |plain64|.  The factor allows
# for the two Cholesky orders rounding differently on the worst-conditioned
# block.
F32_FACTOR, F32_FLOOR = 4.0, 1e-5
# NVIDIA's published H100 SXM peaks (data sheet, dense, at 700 W): device
# memory 3.35 TB/s; float64 34 TFLOP/s and float32 67 TFLOP/s outside the
# tensor cores.  A kernel's least time is the larger of its bytes (inputs
# read once, outputs written once) over the memory rate and its operations
# over the peak of its type.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"float64": 34e12, "float32": 67e12}
K_CAND = 9
TRAIN_WARM, TRAIN_TIMED = 48, 152
NODEWISE_ITERS = 4
REF_ITERS = 4
GATE_ITERS = 4
# the gate phase: m = 40 runs on two rows per lane, m = 64 (m1 = 65) is
# outside every kernel's bound; a Vecchia gp on 12 inputs with 12
# lengthscales
GATE_M, GATE_M_OUTSIDE = 40, 64
GATE_RTOL = 1e-9
# the large-block route (blocks outside the kernels' bound) timed at n=2000
ROUTE_TIMED_M = (64, 100)
# parallel: ptrain against train, the p* methods on the main path's model;
# multistart's starts and its bar on Branin (minimum 0.398)
PARALLEL_ITERS, MULTISTART_STARTS, BRANIN_BAR = 16, 64, 0.5
#: SEM iterations after the timed ones that the parallel phase profiles
PARALLEL_PROFILED = 2
PARALLEL_LGP_POINTS = 200
GATE_GP_N, GATE_GP_D, GATE_GP_SEED = 300, 12, 5
N_PRED = 20000
# design: the metric scores on the card against the same imputations on the
# CPU, per value (relative to the largest magnitude for values below a
# thousandth of it); the RMSE and LOO RMSE at most this factor of the JAX
# package's medians over the protocol's seeds (data/design_n2000.json);
# draws per imputation of the sampling check
DESIGN_RTOL, DESIGN_FACTOR, DESIGN_DRAWS = 1e-9, 2.0, 50
# parity row `2d` (tools/parity.py:72-87): its gate is 1.15x dgpsi's RMSE
# 0.0532 on the same draw (PARITY_r05.json; dgp_tpu gives 0.0361)
TWOD_GATE = 0.0612
TWOD_TRAIN, TWOD_IMPUTATIONS = 500, 50
# gp phase against the JAX package's figures under the same protocol: the
# trained hyper-parameters (the CPU tests hold train() to rtol 1e-6) and the
# Vecchia log-likelihood at them
GP_RTOL_PARAMS, GP_RTOL_LL = 1e-6, 1e-9
# lik_vecchia: the RMSEs at the protocol's seed at most this factor of the
# JAX package's, and the median test nllik over the protocol's training
# seeds at most this many nats above the JAX package's median over the same
# seeds (data/lik_n2000.json).  One seed against one seed says little here:
# which mode the log-variance node settles in (its trained scale lies
# between 5 and 400 in either package) is decided by the seed's first draws
# and moves the nllik by 0.1 nat, more than the slack.
LIK_RMSE_FACTOR, LIK_NLLIK_SLACK = 2.0, 0.05
# large_n: the IVF search's recall against the exact search on the card
# (tests/test_vecchia.py::test_approx_nn_recall's bar), the share of the
# stored rows of the JAX package's IVF neighbours the card's must equal, the
# n = 1e5 DGP's RMSE is gated at twice the JAX package's n = 2000 figure, as
# the main path is (`rmse_gate_ref` of data/vecchia_si_n2000.json: with the
# same function and noise, more data must not predict worse); the mean
# |IVF - exact| of its ensemble predictions on the same imputations
# (tests/test_ensemble.py::test_compiled_ensemble_approx_nn)
LARGE_RECALL, LARGE_ROWS_EQUAL, LARGE_ENS_DIFF = 0.95, 0.999, 0.02
# lik_rows: the gates of tools/parity.py:385-412 on the anchors of
# REF_ANCHORS.json (dgpsi on the same draws): (anchor, additive slack) for
# test_nllik, (anchor, factor) for rmse_mean_vs_truth; protocol: SEM
# iterations, imputations (tools/parity.py:109-210) and the SEM seeds
# (nb_seed; the data's seed is fixed).  `negbin` runs at three seeds and
# its median figures meet the gates: the RMSE of its step mean turns on
# where a fit puts the step, and single seeds of either package land on
# both sides of the gate (tests/torch_lik_spread.json: dgp_tpu 0.83 to 3.87
# over six seeds against 2.3276).
LIK_ROWS = {
    "poisson": {"train": 500, "N": 10, "seeds": (99,), "nllik": (1.9514, 0.02),
                "rmse": None},
    "negbin": {"train": 500, "N": 50, "seeds": (99, 1, 2), "nllik": (1.7002, 0.05),
               "rmse": (1.8621, 1.25)},
    "zip": {"train": 500, "N": 10, "seeds": (99,), "nllik": (1.4125, 0.05),
            "rmse": (0.8502, 1.25)},
}
SOURCES = {
    "block_nllik_grad_parts_t": ("dgp_tpu_torch/csrc/block_nllik_grad.cu",
                                 "dgp_tpu/ops/pallas_vecchia.py:515"),
    "block_loglik_multi_t": ("dgp_tpu_torch/csrc/block_loglik_multi.cu",
                             "dgp_tpu/ops/pallas_vecchia.py:326"),
    "cond_weights_t": ("dgp_tpu_torch/csrc/cond_weights.cu",
                       "dgp_tpu/ops/pallas_vecchia.py:202"),
    "block_loglik_parts_t": ("dgp_tpu_torch/csrc/block_loglik_parts.cu",
                             "dgp_tpu/ops/pallas_vecchia.py:283"),
    "linked_dense_t": ("dgp_tpu_torch/csrc/linked_dense.cu",
                       "none: dgp_tpu's dense linked moments are plain JAX"),
    "vecchia_pred_t": ("dgp_tpu_torch/csrc/vecchia_pred.cu",
                       "none: dgp_tpu's Vecchia predictions are plain JAX"),
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def func(x):
    y1 = (np.sin(7.5 * x) + 1) / 2
    return (2 / 3 * np.sin(2 * (2 * y1 - 1))
            + 4 / 3 * np.exp(-30 * (2 * (2 * y1 - 1)) ** 2) - 1 / 3)


def bench_data():
    rng = np.random.RandomState(123)
    X = rng.rand(N_TRAIN, 1) * 2 - 1
    Y = func(X) + 0.05 * rng.randn(N_TRAIN, 1)
    return X, Y


def twod_data():
    """2d_fct.ipynb cell 2 (copied from tools/parity_data.py:29-43): n=24
    points of a 2-D function and its diagonal test path."""
    f = lambda x, y: np.sin(1 / ((0.7 * x + 0.3) * (0.7 * y + 0.3)))
    X1 = np.array([0, .02, .075, .08, .14, .15, .155, .156, .18, .22, .29,
                   .32, .36, .37, .42, .5, .57, .63, .72, .785, .8, .84,
                   .925, 1])
    X2 = np.array([.29, .02, .12, .58, .38, .87, .01, .12, .22, .08, .34,
                   .185, .64, .02, .93, .15, .42, .71, 1, 0, .21, .5,
                   .785, .21])
    X = np.stack((X1, X2)).T
    Y = f(X1, X2).reshape([-1, 1])
    z1 = np.linspace(0, 1, 100)[:, None]
    z = np.concatenate((z1, z1), axis=1)
    truth = f(z1, z1).reshape(-1, 1)
    return X, Y, z, truth


def cuda_ms(fn, reps=20, warm=3, inner=10):
    """Milliseconds per call: the median over ``reps`` of CUDA-event time
    around ``inner`` calls made back to back, divided by ``inner``.  Queued
    back to back, the calls keep the card busy while the host prepares the
    next one, so a call's own host time counts only where it is longer than
    its device time.  ``inner=1`` times one call alone (the method of the
    first versions' numbers), host time and launch included."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def _data_json(name):
    """A protocol file of dgp_tpu_torch/data in this script's checkout."""
    return json.loads((Path(__file__).resolve().parent / "dgp_tpu_torch" / "data"
                       / name).read_text())


def gp_order(protocol):
    """The gp phase's Vecchia ordering: `to_vecchia` right after
    np.random.seed(vecchia_ord_seed) draws np.random.permutation(n)."""
    return np.random.RandomState(protocol["vecchia_ord_seed"]).permutation(N_TRAIN)


def launch_counts():
    """Kernel launches per wrapper since the last reset (K1-K5)."""
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    return {k: c["launches"] for k, c in cv.launch_counts().items()}


def exact_draw_counts():
    """Exact Hetero-mean draws by path since the process began: the
    program's counters ``exact_draws.<path>``, which an engine's
    ``exact_draws`` views."""
    from dgp_tpu_torch import tracing
    t = tracing.totals("exact_draws.")
    return {k: t.get("exact_draws." + k, 0) for k in ("vecchia", "dense")}


def _dense_checks(launches):
    """A dense DGP's kernels: K5 for its linked layers, and no K1-K4."""
    return {"dense_no_vecchia_kernels": not any(v for k, v in launches.items()
                                                if k != "linked_dense_t"),
            "dense_K5": launches["linked_dense_t"] > 0}


# ----------------------------------------------------------------------
def nvidia_smi():
    """The card's name and power limit as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()


def phase_device():
    import torch
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})


# the kernel's symbol, by wrapper, as it stands in the profiler's events and
# (mangled) in ptxas's entries: the sexp instantiation at R rows per lane is
# f"{name}I{d|f}Li0E" plus "Li{R}E" for the kernels templated on R (K2 has
# an entry point of its own for R = 2)
KERNEL_SYMBOLS = {"block_nllik_grad_parts_t": "block_nllik_grad_kernel",
                  "block_loglik_multi_t": "block_loglik_multi_kernel",
                  "cond_weights_t": "cond_weights_kernel",
                  "block_loglik_parts_t": "block_loglik_parts_kernel"}


def _ptxas_entry(ptxas, kname, dtype_name, rows):
    """ptxas's registers and spills of the sexp kernel of ``kname`` at
    ``rows`` rows per lane."""
    t = "d" if dtype_name == "float64" else "f"
    name = KERNEL_SYMBOLS[kname]
    if kname == "block_loglik_multi_t":
        pat = f"{name}{'_r2' if rows == 2 else ''}I{t}Li0EE"
    else:
        pat = f"{name}I{t}Li0ELi{rows}EE"
    hits = [e for e in ptxas if pat in e["function"]]
    return {k: v for k, v in hits[0].items() if k != "function"} if hits else None


def phase_build():
    import torch
    from dgp_tpu_torch.ops import cuda_linked as cl
    from dgp_tpu_torch.ops import cuda_pred as cp
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    t0 = time.perf_counter()
    cv.build()
    plans = {f"{dt}/{k}": cv.launch_plan(k, getattr(torch, dt), M_TRAIN + 1, 2)
             for dt in ("float64", "float32") for k in cv.KERNEL_ID}
    two_rows = {f"{dt}/{k}/m1={m1}": {**cv.launch_plan(k, getattr(torch, dt), m1, 2),
                                      **(_ptxas_entry(cv.build_info["ptxas"], k, dt, 2) or {})}
                for dt in ("float64", "float32") for k in cv.KERNEL_ID for m1 in (41, 64)}
    linked = {f"{dt}/{name}": cl.launch_plan(getattr(torch, dt), name, 2)
              for dt in ("float64", "float32") for name in ("sexp", "matern2.5")}
    pred = {f"{dt}/{'linked' if lk else 'kriging'}": cp.launch_plan(getattr(torch, dt), lk,
                                                                    m1, 1)
            for dt in ("float64", "float32") for lk, m1 in ((False, 51), (True, 50))}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": cv.build_info["seconds"],
          "ptxas": cv.build_info["ptxas"], "launch_plans_m1_26_d2": plans,
          "launch_plans_two_rows_d2": two_rows, "launch_plans_linked_dense_d2": linked,
          "launch_plans_vecchia_pred_d1": pred})


def _angle_views(f, nu, x, y, ordv, NN, length, dtype, device, nugget, cosv, sinv):
    """K2's operands for one upper node on input (latent, x), as
    CompiledDGP._build_angle_plan and _plan_ll build them; also the
    gather's valid lanes and safe indices."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore
    jit = vcore._f32_jitter(dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    rev = np.flip(NN, axis=1)
    validT = (rev >= 0).T
    safeT = np.where(validT, rev.T, 0)
    sent = cv.sentinels(len(x), safeT.shape[0], dtype, device)
    vt = torch.as_tensor(validT, device=device)

    def view(col):
        g = np.where(validT, (col[ordv] / length)[safeT], 0.0)
        return np.stack([g, np.zeros_like(g)], axis=1)        # (m1, 2, n)

    Cg = np.where(validT, (x[ordv] / length)[safeT], 0.0)
    C = t(np.stack([np.zeros_like(Cg), Cg], axis=1))
    C = torch.where(vt[:, None, :], C, sent[:, None, :])
    yg = t(np.where(validT, y[ordv][safeT], 0.0))
    diag = torch.where(vt, torch.full_like(yg, 1.0 + nugget + jit),
                       torch.ones_like(yg))
    return (t(view(f)), t(view(nu)), C, yg, diag, cosv, sinv), validT, safeT, vt, sent


def _slice_inputs(dtype, device, nugget):
    """Inputs of the four kernels at the main path's shapes, built from the
    bench data the way the port builds them (bench.py's starting
    lengthscale, 0.5; ``nugget`` sets the conditioning): K3 as in
    vecchia.core.cond_weights, K2 as in CompiledDGP._build_angle_plan, K1
    as in CompiledDGP._node_operands + mstep._vecch_fg (both nodes of the
    M-step group, the layer-1 input zero-padded to the group's 2 dims), K4
    as in vecchia.core.vecchia_llik (the layer-2 node, alone and for 9
    candidates of a node-wise ESS round), and the gp phase's K1 and K4 as
    vecchia.api.objective and log_likelihood_func_vecch build them (one
    node, d = 1, the gp's ordering, the JAX package's trained Vecchia
    lengthscale from gp_n2000.json).  The ".../lik" cases are the
    lik_vecchia phase's calls on its own data and starting lengthscales
    (lik_n2000.json): K3 as the prior draw of a layer-2 node on its
    (latent, x) input, K2 under each of the two layer-2 nodes, K1 for the
    M-step group of all three nodes."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore
    from dgp_tpu_torch.vecchia import nn as vnn

    X, Y = bench_data()
    rs = np.random.RandomState(0)
    jit = vcore._f32_jitter(dtype)
    length = 0.5

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ones = t(np.ones(N_TRAIN))
    # K3: layer-1 node, input X
    ordv1 = rs.permutation(N_TRAIN)
    NN1 = torch.as_tensor(vnn.nn(X[ordv1] / length, M_TRAIN, device=device),
                          device=device)
    Xg, _, diag = cv.gather_scale_t(t(X[ordv1]), t(np.zeros(N_TRAIN)), NN1,
                                    t([length]), nugget, ones, jit)
    k3 = (Xg, diag)

    # K2: layer-2 node, input (latent f, global x); candidates cos*f + sin*nu
    f = X[:, 0]                       # the initial latent forwards X
    nu = 0.5 * np.sin(3 * X[:, 0] + 1.0)
    WG = np.column_stack([f, X[:, 0]])
    ordv = rs.permutation(N_TRAIN)
    NN = vnn.nn(WG[ordv] / length, M_TRAIN, device=device)
    ang = np.concatenate([[0.0], rs.uniform(0, 2 * np.pi, K_CAND - 1)])
    cosv, sinv = t(np.cos(ang)), t(np.sin(ang))

    av = (dtype, device, nugget, cosv, sinv)
    k2, validT, safeT, vt, sent = _angle_views(f, nu, X[:, 0], Y[:, 0], ordv, NN, length,
                                               *av)
    A, B, C, yg, diag2 = k2[:5]
    # dl = d: both dims candidate-dependent (C holds the sentinels only)
    g2 = np.where(validT, (np.cos(2 * X[:, 0])[ordv] / length)[safeT], 0.0)
    A2 = A.clone()
    A2[:, 1] = t(g2)
    B2 = B.clone()
    B2[:, 1] = t(np.where(validT, (np.sin(4 * X[:, 0])[ordv] / length)[safeT], 0.0))
    C2 = torch.where(vt[:, None, :], torch.zeros_like(C), sent[:, None, :])
    k2_full = (A2, B2, C2, yg, diag2, cosv, sinv)

    # K4: the layer-2 node at fixed parameters, and its 9 candidates
    NN_t = torch.as_tensor(NN, device=device)
    k4 = cv.gather_scale_t(t(WG[ordv]), t(Y[:, 0][ordv]), NN_t, t([length]),
                           nugget, ones, jit)
    cand = np.stack([np.column_stack([c * f + s * nu, X[:, 0]])
                     for c, s in zip(np.cos(ang), np.sin(ang))])[:, ordv]
    Xc, _, _ = cv.gather_scale_t(t(cand), t(Y[:, 0][ordv]), NN_t, t([length]),
                                 nugget, ones, jit)
    k4_cand = (Xc, k4[1], k4[2])

    # K1: the M-step group {layer-1 node, layer-2 node}, d_max = 2
    X1 = np.column_stack([X[:, 0], np.zeros(N_TRAIN)])
    raw1 = cv.gather_raw_t(t(X1[ordv1]), t(f[ordv1]), NN1, ones)
    raw2 = cv.gather_raw_t(t(WG[ordv]), t(Y[:, 0][ordv]), NN_t, ones)
    Xg_raw, yg1, nug_g, valid = (torch.stack([a, b]) for a, b in zip(raw1, raw2))
    lengths = t([[length, 1.0], [length, length]])
    Xg1, diag1, dnug = cv.scale_blocks_t(Xg_raw, nug_g, valid, lengths,
                                         t([nugget, nugget]), jit)
    k1 = (Xg1, yg1, diag1, dnug)

    # the gp path: K1 with no node axis, K4 at d = 1
    gpj = _data_json("gp_n2000.json")
    ordg = gp_order(gpj["protocol"])
    lg = gpj["jax"]["vecchia"]["length"][0]
    NNg = torch.as_tensor(vnn.nn(X[ordg] / lg, gpj["protocol"]["vecchia_m"],
                                 device=device), device=device)
    Xg_raw, ygg, nugg, validg = cv.gather_raw_t(t(X[ordg]), t(Y[ordg, 0]), NNg, ones)
    Xgg, diagg, dnugg = cv.scale_blocks_t(Xg_raw, nugg, validg, t([lg]), nugget, jit)
    k4_gp = cv.gather_scale_t(t(X[ordg]), t(Y[ordg, 0]), NNg, t([lg]), nugget, ones, jit)

    # the lik_vecchia path: [1 GP] -> [mean GP, log-variance GP on (latent,
    # x)] -> Hetero, on its own data and starting lengthscales.  K3 draws the
    # prior of each layer-2 node on its 2-d input, K2 evaluates layer 1's
    # candidates under both layer-2 nodes (targets: their own latents), and
    # K1 takes the three nodes as one M-step group.
    p = _data_json("lik_n2000.json")["protocol"]
    Xl = lik_data(p)[0]
    xl = Xl[:, 0]
    rl = np.random.RandomState(1)
    fl, nul = xl, 0.5 * np.sin(3 * xl + 1.0)
    targets = (func(Xl)[:, 0], np.log(lik_noise_sd(xl) ** 2))
    WGl = np.column_stack([fl, xl])
    l0 = p["length"][0]
    ord0 = rl.permutation(p["n"])
    NN0 = torch.as_tensor(vnn.nn(Xl[ord0] / l0, p["m"], device=device), device=device)
    raws = [cv.gather_raw_t(t(np.column_stack([xl, np.zeros(p["n"])])[ord0]), t(fl[ord0]),
                            NN0, ones)]
    k2_lik = []
    for lj, yj in zip(p["length"][1:], targets):
        oj = rl.permutation(p["n"])
        NNj = vnn.nn(WGl[oj] / lj, p["m"], device=device)
        k2_lik.append(_angle_views(fl, nul, xl, yj, oj, NNj, lj, *av)[0])
        NNj = torch.as_tensor(NNj, device=device)
        raws.append(cv.gather_raw_t(t(WGl[oj]), t(yj[oj]), NNj, ones))
    Xgl, _, diagl = cv.gather_scale_t(t(WGl[oj]), t(np.zeros(p["n"])), NNj, t([lj]),
                                      nugget, ones, jit)
    Xg_raw, ygl, nug_g, valid = (torch.stack(parts) for parts in zip(*raws))
    lengths = t([[l0, 1.0]] + [[lj, lj] for lj in p["length"][1:]])
    Xg1l, diag1l, dnugl = cv.scale_blocks_t(Xg_raw, nug_g, valid, lengths,
                                            t([nugget] * 3), jit)

    # the linked path on its data (linked_n2000.json): K1 for model 1's gp
    # (one node, one length lane and the nugget lane, at the JAX package's
    # trained length), K3 for the prior draw of model 2's layer-1 node and
    # K2 for its ESS candidates under the layer-2 node (on (latent, x)),
    # both at model 2's trained lengthscales
    lk = _data_json("linked_n2000.json")
    X1k, Y1k, X2k, Y2k = linked_data(lk["protocol"])
    mk, rk = lk["protocol"]["m"], np.random.RandomState(2)
    lg, (h1, h2) = lk["gp"]["length"][0], lk["dgp"]["layers"]
    ok = rk.permutation(N_TRAIN)
    NNk = torch.as_tensor(vnn.nn(X1k[ok] / lg, mk, device=device), device=device)
    rawk = cv.gather_raw_t(t(X1k[ok]), t(Y1k[ok, 0]), NNk, ones)
    Xgk, diagk, dnugk = cv.scale_blocks_t(rawk[0], rawk[2], rawk[3], t([lg]), nugget, jit)
    ok = rk.permutation(N_TRAIN)
    NNk = torch.as_tensor(vnn.nn(X2k[ok] / h1["length"][0], mk, device=device), device=device)
    Xg3k, _, diag3k = cv.gather_scale_t(t(X2k[ok]), t(np.zeros(N_TRAIN)), NNk,
                                        t(h1["length"]), nugget, ones, jit)
    x2 = X2k[:, 0]
    l2 = h2["length"][0]
    ok = rk.permutation(N_TRAIN)
    NNk = vnn.nn(np.column_stack([x2, x2])[ok] / l2, mk, device=device)
    k2k = _angle_views(x2, 0.5 * np.sin(3 * x2 + 1.0), x2, Y2k[:, 0], ok, NNk, l2, *av)[0]
    return {"block_nllik_grad_parts_t/linked": (Xgk, rawk[1], diagk, dnugk),
            "cond_weights_t/linked": (Xg3k, diag3k), "block_loglik_multi_t/linked": k2k,
            "cond_weights_t/lik": (Xgl, diagl),
            "block_loglik_multi_t/lik0": k2_lik[0], "block_loglik_multi_t/lik1": k2_lik[1],
            "block_nllik_grad_parts_t/lik": (Xg1l, ygl, diag1l, dnugl),
            "cond_weights_t": k3, "block_loglik_multi_t": k2,
            "block_loglik_multi_t/dl=d": k2_full, "block_loglik_parts_t": k4,
            "block_loglik_parts_t/K=9": k4_cand, "block_nllik_grad_parts_t": k1,
            "block_nllik_grad_parts_t/gp": (Xgg, ygg, diagg, dnugg),
            "block_loglik_parts_t/gp": k4_gp}


def _large_inputs(dtype, device, nugget):
    """The four kernels' inputs at the large_n phase's shapes, n = 1e5, on
    its data at bench.py's starting lengthscale 0.5, built as its DGP's
    calls build them, with the neighbours of the IVF search: K3 for the
    layer-2 node's prior draw (26, 2, n), K2 under the layer-2 node with 9
    candidates (26, 2, n), K4 for the layer-2 node (26, 2, n) and K1 for the
    M-step group of both nodes (2, 26, 2, n)."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore
    from dgp_tpu_torch.vecchia import nn as vnn

    X, Y = large_data(_data_json("large_n1e5.json")["protocol"])
    n, x, length = len(X), X[:, 0], 0.5
    rs = np.random.RandomState(3)
    jit = vcore._f32_jitter(dtype)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    ones = t(np.ones(n))
    WG = np.column_stack([x, x])           # the initial latent forwards x
    ord1, ord2 = rs.permutation(n), rs.permutation(n)
    NN1 = torch.as_tensor(vnn.nn(X[ord1] / length, M_TRAIN, method="approx",
                                 device=device), device=device)
    NN2 = vnn.nn(WG[ord2] / length, M_TRAIN, method="approx", device=device)
    NN2_t = torch.as_tensor(NN2, device=device)
    Xg3, _, diag3 = cv.gather_scale_t(t(WG[ord2]), t(np.zeros(n)), NN2_t, t([length]),
                                      nugget, ones, jit)
    ang = np.concatenate([[0.0], rs.uniform(0, 2 * np.pi, K_CAND - 1)])
    k2 = _angle_views(x, 0.5 * np.sin(3 * x + 1.0), x, Y[:, 0], ord2, NN2, length, dtype,
                      device, nugget, t(np.cos(ang)), t(np.sin(ang)))[0]
    k4 = cv.gather_scale_t(t(WG[ord2]), t(Y[ord2, 0]), NN2_t, t([length]), nugget, ones, jit)
    raw1 = cv.gather_raw_t(t(np.column_stack([x, np.zeros(n)])[ord1]), t(x[ord1]), NN1, ones)
    raw2 = cv.gather_raw_t(t(WG[ord2]), t(Y[ord2, 0]), NN2_t, ones)
    Xg_raw, yg1, nug_g, valid = (torch.stack([a, b]) for a, b in zip(raw1, raw2))
    Xg1, diag1, dnug = cv.scale_blocks_t(Xg_raw, nug_g, valid,
                                         t([[length, 1.0], [length, length]]),
                                         t([nugget, nugget]), jit)
    return {"cond_weights_t/n1e5": (Xg3, diag3), "block_loglik_multi_t/n1e5": k2,
            "block_loglik_parts_t/n1e5": k4,
            "block_nllik_grad_parts_t/n1e5": (Xg1, yg1, diag1, dnug)}


def _err64(out, ref, per_value):
    worst, ok, detail = 0.0, True, []
    for a, b in zip(out, ref):
        d = (a - b).abs()
        worst = max(worst, float(d.max()))
        if per_value:
            bad = int((d > ATOL64 + RTOL64 * b.abs()).sum())
        else:
            bad = int(float(d.max()) > RTOL64 * float(b.abs().max()))
        ok &= bad == 0 and bool(a.isfinite().all())
        detail.append({"max_abs_err": float(d.max()), "max_abs": float(b.abs().max()),
                       "violations": bad})
    return ok, worst, detail


def _err32(out32, ref32, ref64):
    worst, ok, detail = 0.0, True, []
    for a, p, r in zip(out32, ref32, ref64):
        e_k = float((a.double() - r).abs().max())
        e_p = float((p.double() - r).abs().max())
        bound = F32_FACTOR * e_p + F32_FLOOR * float(r.abs().max())
        ok &= bool(a.isfinite().all()) and e_k <= bound
        worst = max(worst, e_k)
        detail.append({"kernel_err": e_k, "plain_err": e_p, "bound": bound})
    return ok, worst, detail


def _compare(kname, kern, plain, well64, in64, in32, kw):
    """Kernel against plain version.  float64: per value on well-conditioned
    blocks, normwise on the main path's blocks.  float32: against the
    float64 plain version on the same (upcast) inputs, so that only the
    kernel's float32 arithmetic is measured."""
    import torch
    rows = []
    for label, ins, per_value in (("well", well64, True), ("bench", in64, False)):
        out = kern(*ins, **kw)
        ref = plain(*ins, **kw)
        torch.cuda.synchronize()
        ok, err, det = _err64(out, ref, per_value)
        rows.append({"kernel": kname, "dtype": "float64", "blocks": label,
                     "per_value": per_value, "shape": list(ins[0].shape),
                     "ok": ok, "max_abs_err": err, "detail": det})
    out32 = kern(*in32, **kw)
    ref32 = plain(*in32, **kw)
    ref32_64 = plain(*[a.double() for a in in32], **kw)
    ok32, err32, det = _err32(out32, ref32, ref32_64)
    row32 = {"kernel": kname, "dtype": "float32", "blocks": "bench", "ok": ok32,
             "max_abs_err_vs_f64": err32, "detail": det}
    if kname == "block_loglik_multi_t":
        ll64 = -0.5 * (ref32_64[0] + ref32_64[1]).sum(dim=1)
        ll32 = -0.5 * (out32[0].double() + out32[1].double()).sum(dim=1)
        rel = float(((ll32 - ll64).abs() / ll64.abs()).max())
        row32.update(loglik_rel_err=rel, ok=ok32 and rel < REL_LL32)
    return rows + [row32]


# Edges of the warp-per-block mapping.  K1: (m1, n, G, d, n_length,
# nugget_est); K2: (m1, n, d, dl, K); K3: (m1, n, d); K4: (m1, n, d, K,
# targets) with K = 0 for no candidate axis and the targets and diagonals
# "shared" by all candidates ((m1, n)) or each candidate's "own" ((K, m1, n)).
# K2's one-row path also with K = 2 and 8, with 9 at d = 5 (dl = 2, three
# static dims) and d = 3 (dl = 1), 7 at m1 = 32 over d = 3 (dl = 2), and a
# non-positive pivot with 2 candidates.
# Then the two-rows-per-lane instantiation (33 <= m1 <= 64: the first
# block that needs it, whose panel 2 has one row; the gate phase's m = 40;
# panel 2 of 16 rows; the last two), K1 with 12 length lanes (two passes of
# 8 over the pairs; 12 lanes over 13 dims at m1 = 33), 16 (the nugget lane
# alone in the third pass) and 17 (a length lane in it), at m1 = 64 with 9
# and 12 and at m1 = 41 with 24, and blocks with a non-positive pivot at m1
# = 26 (also with 12 lanes), at m1 = 33 (in panel 1) and at m1 = 64 (rows 0
# and 32: in each panel).  Every case runs under sexp and Matern-2.5.
EDGE_K1 = ((32, 2001, 2, 2, 1, False), (2, 3, 1, 2, 2, True), (26, 2001, 1, 5, 5, True),
           (33, 2001, 2, 2, 2, True), (41, 2001, 2, 2, 1, True), (64, 2001, 2, 2, 2, False),
           (26, 2001, 2, 12, 12, True), (26, 2001, 1, 12, 12, False), (64, 501, 1, 9, 9, True),
           (41, 301, 2, 12, 1, True), (48, 2001, 2, 2, 2, True), (63, 2001, 1, 3, 3, False),
           (26, 2001, 2, 16, 16, True), (26, 2001, 1, 17, 17, False), (64, 501, 1, 12, 12, True),
           (41, 301, 2, 24, 24, True), (33, 2001, 2, 13, 12, True))
EDGE_K2 = ((32, 2001, 2, 1, 9), (2, 3, 2, 1, 1), (26, 2001, 5, 0, 1), (26, 500, 3, 1, 3),
           (33, 2001, 2, 1, 9), (41, 2001, 2, 1, 9), (64, 2001, 2, 1, 9), (64, 301, 3, 1, 2),
           (48, 2001, 2, 1, 9), (63, 2001, 2, 0, 3), (26, 2001, 2, 1, 2), (26, 2001, 2, 1, 8),
           (26, 2001, 5, 2, 9), (26, 2001, 3, 1, 9), (32, 2001, 3, 2, 7))
EDGE_K3 = ((32, 2001, 2), (2, 3, 2), (26, 2001, 5), (33, 2001, 2), (41, 2001, 1),
           (64, 2001, 2), (48, 2001, 2), (63, 2001, 1))
EDGE_K4 = ((32, 2001, 2, 0, "shared"), (2, 3, 2, 0, "shared"), (26, 2001, 5, 0, "shared"),
           (26, 2001, 2, 9, "shared"), (26, 2001, 2, 9, "own"), (33, 2001, 2, 0, "shared"),
           (41, 2001, 2, 9, "shared"), (64, 2001, 2, 0, "shared"), (64, 2001, 2, 3, "own"),
           (48, 2001, 2, 0, "shared"), (63, 2001, 2, 3, "own"))
NAN_K1 = ((26, 300, 2, 2, 2, True), (64, 300, 2, 2, 2, True), (33, 300, 2, 2, 2, True),
          (26, 300, 2, 12, 12, True))
NAN_K2 = ((26, 300, 2, 1, 3), (64, 300, 2, 1, 3), (33, 300, 2, 1, 3), (26, 300, 2, 1, 2))
NAN_K3 = ((26, 300, 2), (64, 300, 2), (33, 300, 2))
NAN_K4 = ((26, 300, 2, 3, "own"), (64, 300, 2, 3, "own"), (33, 300, 2, 3, "own"))
EDGES = (("block_nllik_grad_parts_t", EDGE_K1, NAN_K1), ("block_loglik_multi_t", EDGE_K2, NAN_K2),
         ("cond_weights_t", EDGE_K3, NAN_K3), ("block_loglik_parts_t", EDGE_K4, NAN_K4))
# timed beside the main path's cases: each kernel at m1 = 41, 48, 63 and 64
# (d = 2, n = 2000; K2 with 9 candidates, K4 alone), K1 at d = 12 and 16
# with as many length lanes, and K2 at m1 = 26 with no static dim (dl = 0)
# and with two (d = 3, dl = 1), on the edge cases' random blocks
TWO_ROW_M1 = (41, 48, 63, 64)
VARIANT_TIMES = (*(("block_nllik_grad_parts_t", (m1, 2000, 2, 2, 2, True)) for m1 in TWO_ROW_M1),
                 ("block_nllik_grad_parts_t", (26, 2000, 2, 12, 12, True)),
                 ("block_nllik_grad_parts_t", (26, 2000, 2, 16, 16, True)),
                 *(("block_loglik_multi_t", (m1, 2000, 2, 1, 9)) for m1 in TWO_ROW_M1),
                 ("block_loglik_multi_t", (26, 2000, 2, 0, 9)),
                 ("block_loglik_multi_t", (26, 2000, 3, 1, 9)),
                 *(("cond_weights_t", (m1, 2000, 2)) for m1 in TWO_ROW_M1),
                 *(("block_loglik_parts_t", (m1, 2000, 2, 0, "shared")) for m1 in TWO_ROW_M1))


def _edge_inputs(kname, shape, seed, bad=False):
    """Well-conditioned random blocks (float64 numpy) for a kernel at an
    edge shape: coordinates in [-2, 2] (pre-scaled), 15% sentinel lanes
    (none where a correlation factor spans more than 2 dims), nugget 0.1.
    With ``bad``, every 7th point's block gets a non-positive pivot
    (diagonal 0 in the middle row, or -1 in the first)."""
    rs = np.random.RandomState(seed)
    xlead = ()                               # leading axes of K3/K4's X
    if kname == "block_nllik_grad_parts_t":
        m1, n, G, d = shape[:4]
        lead = (G,)
        wide = d
    elif kname == "block_loglik_multi_t":
        m1, n, d, dl = shape[:4]
        lead = ()
        dlc = d if dl == 0 or dl >= d else dl
        wide = max(dlc, d - dlc)
    else:
        m1, n, d = shape[:3]
        if kname == "block_loglik_parts_t" and shape[3]:
            xlead = (shape[3],)
        lead = xlead if kname == "block_loglik_parts_t" and shape[4] == "own" else ()
        wide = d
    # K1, K3 and K4 build one correlation factor over all d dims, K2 two,
    # split at dl (the d = 3, dl = 1 case: 1 + 2 dims).  In float32,
    # Matern-2.5's product of per-dim factors at a sentinel distance
    # overflows over 3 dims (inf * 0 = NaN), in the plain version as in the
    # kernel
    valid = rs.uniform(size=lead + (m1, n)) > (0.15 if wide <= 2 else 0.0)
    valid[..., -1, :] = True
    sent = 1e7 + np.arange(n)[None, :] * 1e3 + np.arange(m1)[:, None] * 7e2
    y = np.where(valid, rs.uniform(-1, 1, valid.shape), 0.0)
    diag = np.where(valid, 1.1, 1.0)
    if bad:
        diag[..., m1 // 2, ::14] = 0.0
        diag[..., 0, 7::14] = -1.0
    if kname == "block_nllik_grad_parts_t":
        X = rs.uniform(-2, 2, lead + (m1, d, n))
        X = np.where(valid[..., :, None, :], X, sent[:, None, :])
        return X, y, diag, np.where(valid, 0.1, 0.0)
    if kname in ("cond_weights_t", "block_loglik_parts_t"):
        X = rs.uniform(-2, 2, xlead + (m1, d, n))
        X = np.where(valid[..., :, None, :], X, sent[:, None, :])
        return (X, diag) if kname == "cond_weights_t" else (X, y, diag)
    K = shape[4]
    A = np.zeros((m1, d, n))
    B = np.zeros((m1, d, n))
    A[:, :dlc] = rs.uniform(-1, 1, (m1, dlc, n))
    B[:, :dlc] = rs.uniform(-1, 1, (m1, dlc, n))
    C = np.zeros((m1, d, n))
    C[:, dlc:] = rs.uniform(-2, 2, (m1, d - dlc, n))
    C = np.where(valid[:, None, :], C, sent[:, None, :])
    A = np.where(valid[:, None, :], A, 0.0)
    B = np.where(valid[:, None, :], B, 0.0)
    ang = rs.uniform(0, 2 * np.pi, K)
    return A, B, C, y, diag, np.cos(ang), np.sin(ang)


def _edge_kw(kname, shape, name):
    if kname == "block_nllik_grad_parts_t":
        return {"name": name, "n_length": shape[4], "nugget_est": shape[5]}
    if kname == "block_loglik_multi_t":
        return {"name": name, "dl": shape[3]}
    return {"name": name}


def _compare_edges(dev):
    """Each kernel against its plain version at the edge shapes, float64
    per value and float32 against the float64 plain version, and the NaN
    pattern of blocks with a non-positive pivot."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    rows = []
    cases = [(kname, s, bad) for kname, edges, nans in EDGES
             for s, bad in [(s, False) for s in edges] + [(s, True) for s in nans]]
    for name in ("sexp", "matern2.5"):
        for seed, (kname, shape, bad) in enumerate(cases):
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            kw = _edge_kw(kname, shape, name)
            raw = _edge_inputs(kname, shape, seed, bad)
            in64 = [torch.as_tensor(a, dtype=torch.float64, device=dev) for a in raw]
            in32 = [a.float() for a in in64]
            out, ref = kern(*in64, **kw), plain(*in64, **kw)
            out32, ref32 = kern(*in32, **kw), plain(*in32, **kw)
            ref32_64 = plain(*[a.double() for a in in32], **kw)
            torch.cuda.synchronize()
            base = {"kernel": kname, "case": "edge", "shape": list(shape), "name": name}
            if bad:
                for dt, o, r in (("float64", out, ref), ("float32", out32, ref32)):
                    nan_o = [a.isnan() for a in o]
                    nan_r = [b.isnan() for b in r]
                    same = all(bool((a == b).all()) for a, b in zip(nan_o, nan_r))
                    bad_pts = int(nan_r[0].sum())
                    ok, err, _ = _err64([a[~m] for a, m in zip(o, nan_r)],
                                        [b[~m] for b, m in zip(r, nan_r)], True) \
                        if dt == "float64" else (True, None, None)
                    rows.append(dict(base, dtype=dt, blocks="non-positive pivot",
                                     nan_points=bad_pts, nan_pattern_equal=same,
                                     ok=same and bad_pts > 0 and ok, max_abs_err=err))
                continue
            ok, err, det = _err64(out, ref, True)
            rows.append(dict(base, dtype="float64", blocks="well", per_value=True, ok=ok,
                             max_abs_err=err, detail=det))
            ok32, err32, det32 = _err32(out32, ref32, ref32_64)
            rows.append(dict(base, dtype="float32", blocks="well", ok=ok32,
                             max_abs_err_vs_f64=err32, detail=det32))
    return rows


def _blocks_of(kname, ins, name="sexp"):
    """The (batch, m1, m1) correlation blocks with their diagonals that
    `kname` factors on these inputs: what torch.linalg.cholesky_ex is timed
    on as the library yardstick."""
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.ops import kernels as kops
    if kname == "block_loglik_multi_t":             # dl = 1, K candidates
        A, B, C, _, diag, cosv, sinv = ins
        c, s = cosv[:, None, None, None], sinv[:, None, None, None]
        lat = c * A[:, :1] + s * B[:, :1] + C[:, :1]
        Kc = cv._corr_blocks(lat, name) * cv._corr_blocks(C[:, 1:], name)
    else:
        Kc = cv._corr_blocks(ins[0], name)
        diag = ins[1] if kname == "cond_weights_t" else ins[2]
    K = kops.set_diag(Kc, diag.transpose(-1, -2))
    return K.reshape(-1, K.shape[-2], K.shape[-1]).contiguous()


def _bound_ms(kname, ins, dtype_name, kw):
    """Least time (ms) the card could take for one call on these inputs,
    and which of bytes or operations bounds it.  Operations count the sexp
    pipeline's floating-point work per block (an exponential or a square
    root counts as one): the correlation pairs, the column Cholesky, the
    substitutions and, for K1, the gradient (``kw``: the call's n_length
    and nugget_est).  K2 counts the TPU kernel's algorithm (``kw``: the
    call's dl): where 0 < dl < d the static dims' correlation factor once
    a point, and for each candidate its coordinates and correlation over
    the dl latent dims times that factor; otherwise each candidate's
    whole coordinates and correlation.  K1's gradient has two algorithms,
    whichever needs fewer operations on these shapes counting: p forward
    substitutions of dK_k z, or one more backward substitution and the
    quadratic forms z^T dK_k z and a^T dK_k z summed over the pairs i < j.
    The count does not depend on the kernel's design, so rows stay
    comparable across designs."""
    m1 = ins[0].shape[-3]
    d = ins[0].shape[-2]
    n = ins[0].shape[-1]
    pairs = m1 * (m1 - 1) // 2
    chol = sum(2 * j + 1 + (m1 - 1 - j) * (2 * j + 2) for j in range(m1))
    corr = pairs * (3 * d + 1)
    solve = m1 * m1
    in_elems = sum(t.numel() for t in ins)
    once = 0                                         # operations once a point
    if kname == "cond_weights_t":
        blocks, per = n, corr + chol + (m1 - 1) ** 2
        out_elems = m1 * n
    elif kname == "block_loglik_multi_t":
        K = ins[5].shape[0]
        dl = kw.get("dl")
        dl = d if dl is None or dl == 0 or dl >= d else dl
        lat = 4 * m1 * dl + pairs * (3 * dl + 1)
        if dl < d:
            once = pairs * (3 * (d - dl) + 1)
            lat += pairs                             # times the static factor
        blocks, per = K * n, lat + chol + solve
        out_elems = 2 * K * n
    elif kname == "block_loglik_parts_t":
        blocks = ins[0].numel() // (m1 * d)
        per = corr + chol + solve
        out_elems = 2 * blocks
    else:                                            # K1
        G = ins[0].shape[0] if ins[0].ndim == 4 else 1
        nlen = kw["n_length"]
        nug = int(kw["nugget_est"])
        p = nlen + nug
        blocks = G * n
        forward = pairs * nlen * 6 + m1 + p * (solve + 2 * m1 + 4)
        pair_forms = solve + pairs * (6 * nlen + 6) + 2 * m1 + 4 * m1 * nug + 4 * p
        per = corr + chol + 2 * solve + min(forward, pair_forms)
        out_elems = 2 * G * n + 2 * G * p * n
    nbytes = (in_elems + out_elems) * ins[0].element_size()
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (blocks * per + n * once) / PEAK_OPS_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(dev):
    import torch
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t0 = time.perf_counter()
    results = {k: {"max_abs_err": 0.0} for k in cv.KERNEL_ID}
    failures = []
    well64, in64, in32 = ({**_slice_inputs(dt, dev, nug), **_large_inputs(dt, dev, nug)}
                          for dt, nug in ((torch.float64, NUGGET_WELL),
                                          (torch.float64, NUGGET_BENCH),
                                          (torch.float32, NUGGET_BENCH)))
    grad_kw = {"n_length": 2, "nugget_est": True}
    cases = (("cond_weights_t", "cond_weights_t", {}),
             ("block_loglik_multi_t", "block_loglik_multi_t", {"dl": 1}),
             ("block_loglik_multi_t", "block_loglik_multi_t/dl=d", {"dl": 2}),
             ("block_loglik_parts_t", "block_loglik_parts_t", {}),
             ("block_loglik_parts_t", "block_loglik_parts_t/K=9", {}),
             ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t", grad_kw),
             ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/gp",
              {"n_length": 1, "nugget_est": True}),
             ("block_loglik_parts_t", "block_loglik_parts_t/gp", {}),
             ("cond_weights_t", "cond_weights_t/lik", {}),
             ("block_loglik_multi_t", "block_loglik_multi_t/lik0", {"dl": 1}),
             ("block_loglik_multi_t", "block_loglik_multi_t/lik1", {"dl": 1}),
             ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/lik", grad_kw),
             ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/linked",
              {"n_length": 1, "nugget_est": True}),
             ("cond_weights_t", "cond_weights_t/linked", {}),
             ("block_loglik_multi_t", "block_loglik_multi_t/linked", {"dl": 1}),
             ("cond_weights_t", "cond_weights_t/n1e5", {}),
             ("block_loglik_multi_t", "block_loglik_multi_t/n1e5", {"dl": 1}),
             ("block_loglik_parts_t", "block_loglik_parts_t/n1e5", {}),
             ("block_nllik_grad_parts_t", "block_nllik_grad_parts_t/n1e5", grad_kw))
    compared = []
    for name in ("sexp", "matern2.5"):
        for kname, case, kw in cases:
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            rows = _compare(kname, kern, plain, well64[case], in64[case], in32[case],
                            dict(kw, name=name))
            compared.append(rows)
            results[kname]["max_abs_err"] = max(results[kname]["max_abs_err"],
                                                rows[0]["max_abs_err"],
                                                rows[1]["max_abs_err"])
            for r in rows:
                emit({"phase": "kernels", "name": name, "case": case, **r})
                if not r["ok"]:
                    failures.append(r)
    edges = _compare_edges(dev)
    comparisons = sum(len(v) for v in (edges, *compared))
    for r in edges:
        emit({"phase": "kernels", **r})
        if r["dtype"] == "float64" and r["max_abs_err"] is not None:
            results[r["kernel"]]["max_abs_err"] = max(results[r["kernel"]]["max_abs_err"],
                                                      r["max_abs_err"])
        if not r["ok"]:
            failures.append(r)
    # times at the main path's configuration (sexp; K2 with K=9, dl=1; K4
    # as the single (26, 2, 2000) call and with its 9 candidates) and the gp
    # phase's; the summary line takes each kernel's case of its own name
    timing = {}
    for dt, ins in (("float64", in64), ("float32", in32)):
        for kname, case, kw in cases:
            if case == "block_loglik_multi_t/dl=d":
                continue
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            kw = dict(kw, name="sexp")
            args = ins[case]
            blocks = _blocks_of(kname, args)
            bound, by = _bound_ms(kname, args, dt, kw)
            # n = 1e5: 50x the work of a call at n = 2000, timed over fewer calls
            reps = {"reps": 5, "inner": 2} if case.endswith("/n1e5") else {}
            timing[f"{dt}/{case}"] = {
                "ms": cuda_ms(lambda: kern(*args, **kw), **reps),
                "ms_one_call": cuda_ms(lambda: kern(*args, **kw), inner=1),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw), **reps),
                "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(blocks), **reps),
                "library_ms_one_call": cuda_ms(lambda: torch.linalg.cholesky_ex(blocks),
                                               inner=1),
                "bound_ms": bound, "bound_by": by,
                "shape": list(args[0].shape)}
            del blocks
    # the two-rows-per-lane instantiation and K1 with 12 and 16 length lanes
    for dt in ("float64", "float32"):
        for kname, shape in VARIANT_TIMES:
            kern = getattr(cv, kname)
            plain = getattr(cv, kname + "_plain")
            kw = _edge_kw(kname, shape, "sexp")
            args = [torch.as_tensor(a, dtype=getattr(torch, dt), device=dev)
                    for a in _edge_inputs(kname, shape, 0)]
            blocks = _blocks_of(kname, args)
            bound, by = _bound_ms(kname, args, dt, kw)
            timing[f"{dt}/{kname}/{list(shape)}"] = {
                "ms": cuda_ms(lambda: kern(*args, **kw)),
                "ms_one_call": cuda_ms(lambda: kern(*args, **kw), inner=1),
                "plain_ms": cuda_ms(lambda: plain(*args, **kw)),
                "library_ms": cuda_ms(lambda: torch.linalg.cholesky_ex(blocks)),
                "bound_ms": bound, "bound_by": by, "shape": list(args[0].shape)}
    for kname in results:
        results[kname].update(timing["float64/" + kname])
    emit({"phase": "kernels", "comparisons": comparisons, "failed": len(failures),
          "timing_ms": timing, "seconds": time.perf_counter() - t0})
    if failures:
        raise SystemExit(f"kernel comparisons failed: {len(failures)}")
    return results


# K5, the dense linked moments: the lgp_n2000.predict cell's dense call (M =
# 250 queries, n = 2000, Dw = 2, sexp) and the same at matern2.5, timed; and
# compared with the plain version also at n = 37 and 1999, D = 1 and 3, with
# row weights and a zero-variance dim.  Float64 per value: |kernel - plain|
# <= LINKED_RTOL64 * the sum of the terms' magnitudes (the plain version on
# |Rinv| and |a|): up to 4e6 terms added in another order, and matern's
# closed form, whose polynomial terms cancel, with fused multiply-adds.
# Float32: the F32_FACTOR rule of K1-K4 against the float64 plain values.
LINKED_SHAPE = (250, 2000, 2)
LINKED_CASES = ((1, 37, 1, False), (15, 1999, 3, True), (250, 2000, 2, False),
                (250, 2000, 2, True))
LINKED_RTOL64 = 1e-11


def _linked_dense_inputs(name, M, n, D, weights, dtype, dev, seed=0):
    """K5's arguments (X, m, v, W, Rinv, a, length) for a dense node at n
    points of [0, 1]^D (sexp GP statistics, nugget 1e-4) and M queries;
    with ``weights`` row weights from a global input, and every other
    query deterministic in dim 0."""
    import torch
    from dgp_tpu_torch import gp_core
    from dgp_tpu_torch.ops import kernels
    rs = np.random.RandomState(seed)
    X = rs.uniform(0, 1, (n, D + 1))
    length = rs.uniform(0.3, 0.6, D + 1)
    y = np.sin(4 * X.sum(1))
    m = rs.uniform(0, 1, (M, D))
    v = rs.uniform(0.001, 0.05, (M, D))
    if weights:
        v[::2, 0] = 0.0
    z = rs.uniform(0, 1, (M, 1))
    f64 = dict(dtype=torch.float64, device=dev)
    cols = D + 1 if weights else D
    Xt = torch.as_tensor(X[:, :cols], **f64)
    lt = torch.as_tensor(length[:cols], **f64)
    Rinv, a = gp_core.compute_stats(Xt, torch.as_tensor(y, **f64), lt, 1e-4, name="sexp")
    W = (kernels.k_vec(Xt[:, D:], torch.as_tensor(z, **f64), lt[D:], name)
         if weights else None)
    out = (Xt[:, :D], torch.as_tensor(m, **f64), torch.as_tensor(v, **f64), W, Rinv, a,
           lt[:D])
    return tuple(None if t is None else t.to(dtype).contiguous() for t in out)


def _linked_bound_ms(M, n, D, dtype_name):
    """K5's least time (ms): the operations K5 needs over the type's peak,
    or its bytes (inputs once, outputs once) over the memory rate.  Per
    query: I over n points, and J, the trace and the quadratic form over
    the n (n + 1) / 2 pairs of the upper triangle (J and Rinv being
    symmetric), each pair costing what benchmark/counts/ops.py's
    `linkgp_dense` counts for one of its n^2."""
    ops = M * (n * (5 * D + 2) + n * (n + 1) // 2 * (8 * D + 2 + 4) + 4 * n)
    size = 8 if dtype_name == "float64" else 4
    nbytes = (2 * M * D + n * D + n * n + n + 3 * M) * size
    t_ops, t_bytes = ops / PEAK_OPS_S[dtype_name] * 1e3, nbytes / PEAK_BYTES_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def phase_linked_dense(dev):
    """K5 against its plain version, and timed at the cell's shape; returns
    the kernel summary's row (float64 sexp at the cell's shape)."""
    import torch
    from dgp_tpu_torch.ops import cuda_linked as cl

    t0 = time.perf_counter()
    rows, failures = [], []
    for name in ("sexp", "matern2.5"):
        for M, n, D, weights in LINKED_CASES:
            args = _linked_dense_inputs(name, M, n, D, weights, torch.float64, dev,
                                        seed=M + n + D)
            ref = cl.linked_dense_t_plain(*args, name=name)
            X, m, v, W, Rinv, a, length = args
            mag = cl.linked_dense_t_plain(X, m, v, W, Rinv.abs(), a.abs(), length, name=name)
            out = cl.linked_dense_t(*args, name=name)
            args32 = tuple(None if t is None else t.float() for t in args)
            out32 = cl.linked_dense_t(*args32, name=name)
            ref32 = cl.linked_dense_t_plain(*args32, name=name)
            torch.cuda.synchronize()
            for k, (o, r, s, o32, r32) in enumerate(zip(out, ref, mag, out32, ref32)):
                err = float((o - r).abs().max())
                rel = float(((o - r).abs() / s).max())
                err32 = float((o32.double() - r).abs().max())
                band32 = float((r32.double() - r).abs().max())
                row = {"phase": "linked_dense", "name": name, "M": M, "n": n, "D": D,
                       "weights": weights, "output": ("mu", "tr", "quad")[k],
                       "max_abs_err": err, "max_err_over_magnitude": rel,
                       "float32_err": err32, "float32_plain_err": band32,
                       "ok": bool(rel <= LINKED_RTOL64 and err32 <= F32_FACTOR * band32
                                  + F32_FLOOR * float(s.max()))}
                rows.append(row)
                emit(row)
                if not row["ok"]:
                    failures.append(row)
    M, n, D = LINKED_SHAPE
    timing = {}
    for dt in ("float64", "float32"):
        for name in ("sexp", "matern2.5"):
            args = _linked_dense_inputs(name, M, n, D, False, getattr(torch, dt), dev)
            call = lambda: cl.linked_dense_t(*args, name=name)
            bound, by = _linked_bound_ms(M, n, D, dt)
            timing[f"{dt}/{name}"] = {
                "ms": cuda_ms(call, reps=5, inner=3), "ms_one_call": cuda_ms(call, inner=1),
                "plain_ms": cuda_ms(lambda: cl.linked_dense_t_plain(*args, name=name), reps=2,
                                    warm=1, inner=1),
                "bound_ms": bound, "bound_by": by, "shape": [M, n, D],
                "plan": cl.launch_plan(getattr(torch, dt), name, D)}
    launches = launch_counts()["linked_dense_t"]
    emit({"phase": "linked_dense", "comparisons": len(rows), "failed": len(failures),
          "timing_ms": timing, "launches": launches, "seconds": time.perf_counter() - t0})
    if failures:
        raise SystemExit(f"K5 comparisons failed: {len(failures)}")
    row = timing["float64/sexp"]
    return {"max_abs_err": max(r["max_abs_err"] for r in rows if r["name"] == "sexp"),
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None}


# K6, a Vecchia node's prediction: the lgp_n2000.predict cell's kriging
# (matern2.5, k = 50 neighbours, m1 = 51) and linked (sexp, k = 50, Dw = 1)
# calls at M = 250 on n = 2000, and the ensemble's scale, M = 8000 on n =
# 1e5; each also with -1 lanes (a third of the rows lose 16 lanes) and a
# global input.  Float64: the mean, and kriging's variance, within
# VPRED_RTOL64 of the largest plain value; the linked variance within
# VPRED_VAR_RTOL64 of the terms it is the sum of, scale (1 + nugget) + mu^2
# a query (the closed form cancels them, and tr(K^-1 J) adds k^2 products of
# K^-1's entries, up to 1 / nugget, with J's, in another order).  Float32:
# the F32_FACTOR rule of K1-K4.
VPRED_CASES = (("kriging", "matern2.5"), ("linked", "sexp"))
VPRED_SHAPES = ((2000, 250), (100_000, 8000))
VPRED_K = 50
VPRED_RTOL64, VPRED_VAR_RTOL64 = 1e-9, 1e-8


def _vecchia_pred_inputs(kind, name, n, M, dtype, dev, holes=False, Dz=0, seed=0):
    """An entry point's arguments: n training points and M queries on [0,
    1]^(1 + Dz), each query's VPRED_K nearest (length-scaled, nearest
    last), scale 1.3, nugget 1e-3 times multipliers in [0.5, 2]; linked
    queries with variances in [0.001, 0.05]."""
    import torch
    rs = np.random.RandomState(seed)
    D = 1 + Dz
    X = rs.uniform(0, 1, (n, D))
    y = np.sin(4 * X.sum(1)) + 0.1 * rs.randn(n)
    length = rs.uniform(0.2, 0.6, D)
    nd = rs.uniform(0.5, 2.0, n)
    q = rs.uniform(0, 1, (M, D))
    qs = torch.as_tensor(q / length, device=dev)
    xs = torch.as_tensor(X / length, device=dev)
    NN = torch.cat([torch.topk(((qs[s:s + 1000, None] - xs[None]) ** 2).sum(-1), VPRED_K,
                               dim=1, largest=False).indices.flip(1)
                    for s in range(0, M, 1000)])
    if holes:
        NN[::3, :VPRED_K // 3] = -1
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
    if kind == "kriging":
        return (t(q), t(X), NN, t(y), 1.3, t(length), 1e-3, t(nd), name)
    v = rs.uniform(0.001, 0.05, (M, 1))
    return (t(q[:, :1]), t(v), t(q[:, 1:]) if Dz else None, t(X[:, :1]),
            t(X[:, 1:]) if Dz else None, NN, t(y), 1.3, t(length), 1e-3, t(nd), name)


def _device_ms(call, symbol, calls=20):
    """The kernels' device ms per call under torch.profiler whose names hold
    ``symbol``: all of them where ``symbol`` is None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = e.cuda_time_total
        if symbol is None or symbol in e.key:
            total += dev_us
    return total / 1e3 / calls


def _host_ms(call, calls=20):
    """Host ms to queue one call, the card's queue not full."""
    import torch
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    host = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return host


def phase_vecchia_pred(dev):
    """K6 against its plain versions, and timed; returns the kernel
    summary's row (float64 linked sexp at the cell's shape)."""
    import torch
    from benchmark.counts import ops as counts
    from dgp_tpu_torch.ops import cuda_pred as cp
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore

    t0 = time.perf_counter()
    entry = {"kriging": (vcore.gp_vecch, vcore.gp_vecch_plain, counts.gp_vecch),
             "linked": (vcore.link_gp_vecch, vcore.link_gp_vecch_plain,
                        counts.link_gp_vecch)}
    peaks = json.loads((Path(__file__).resolve().parent / "benchmark" / "counts"
                        / "peaks.json").read_text())
    rows, failures = [], []
    for kind, name in VPRED_CASES:
        ent, plain, _ = entry[kind]
        for n, M in VPRED_SHAPES:
            for holes, Dz in ((False, 0), (True, 1)):
                args = _vecchia_pred_inputs(kind, name, n, M, torch.float64, dev, holes, Dz,
                                            seed=n + M + Dz)
                before = launch_counts()["vecchia_pred_t"]
                out = ent(*args)
                torch.cuda.synchronize()
                launched = launch_counts()["vecchia_pred_t"] - before
                ref = plain(*args)
                args32 = tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                               else a for a in args)
                out32, ref32 = ent(*args32), plain(*args32)
                err = float((out[0] - ref[0]).abs().max() / ref[0].abs().max())
                if kind == "kriging":
                    err_v = float((out[1] - ref[1]).abs().max() / ref[1].abs().max())
                    tol_v = VPRED_RTOL64
                else:
                    terms = 1.3 * (1 + 1e-3) + ref[0] ** 2
                    err_v = float(((out[1] - ref[1]).abs() / terms).max())
                    tol_v = VPRED_VAR_RTOL64
                ok32 = all(float((o.double() - r).abs().max())
                           <= F32_FACTOR * float((p.double() - r).abs().max())
                           + F32_FLOOR * float(r.abs().max())
                           for o, p, r in zip(out32, ref32, ref))
                row = {"phase": "vecchia_pred", "kind": kind, "name": name, "n": n, "M": M,
                       "k": VPRED_K, "holes": holes, "Dz": Dz, "launches": launched,
                       "mean_err_rel": err, "var_err": err_v,
                       "float32_err": [float((o.double() - r).abs().max())
                                       for o, r in zip(out32, ref)],
                       "float32_plain_err": [float((p.double() - r).abs().max())
                                             for p, r in zip(ref32, ref)],
                       "ok": bool(launched == 1 and err <= VPRED_RTOL64
                                  and err_v <= tol_v and ok32
                                  and all(torch.isfinite(o).all() for o in out))}
                rows.append(row)
                emit(row)
                if not row["ok"]:
                    failures.append(row)
    plans = []
    for linked, m1 in ((False, VPRED_K + 1), (True, VPRED_K)):
        for dt in (torch.float64, torch.float32):
            plan = cp.launch_plan(dt, linked, m1, 1)
            plans.append({"linked": linked, "dtype": str(dt), "m1": m1, **plan,
                          "gate_bytes": cv.shared_bytes("K6", m1, 1, dt)})
            if plan["shared_bytes"] != cv.shared_bytes("K6", m1, 1, dt):
                failures.append(plans[-1])
    timing = {}
    for dt in ("float64", "float32"):
        for kind, name in VPRED_CASES:
            ent, plain, count = entry[kind]
            symbol = "kriging_kernel" if kind == "kriging" else "linked_vecch_kernel"
            for n, M in VPRED_SHAPES:
                args = _vecchia_pred_inputs(kind, name, n, M, getattr(torch, dt), dev)
                ops, nbytes = count(args, {})
                call, pcall = (lambda: ent(*args)), (lambda: plain(*args))
                timing[f"{dt}/{kind}/{name}/M={M}"] = {
                    "ms": cuda_ms(call, reps=10), "ms_one_call": cuda_ms(call, inner=1),
                    "device_ms": _device_ms(call, symbol), "host_ms": _host_ms(call),
                    "plain_ms": cuda_ms(pcall, reps=5, inner=3),
                    "plain_device_ms": _device_ms(pcall, None, calls=5),
                    "plain_host_ms": _host_ms(pcall, calls=5),
                    "bound_ms": counts.least_seconds(ops, nbytes, peaks) * 1e3,
                    "ops": ops, "bytes": nbytes, "shape": [n, M, VPRED_K]}
    emit({"phase": "vecchia_pred", "comparisons": len(rows), "failed": len(failures),
          "plans": plans, "timing_ms": timing, "launches": launch_counts()["vecchia_pred_t"],
          "seconds": time.perf_counter() - t0})
    if failures:
        raise SystemExit(f"K6 comparisons failed: {len(failures)}")
    row = timing[f"float64/linked/sexp/M={VPRED_SHAPES[0][1]}"]
    return {"max_abs_err": max(r["mean_err_rel"] for r in rows), "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": "operations", "library_ms": None}


def _params_json():
    return _data_json("vecchia_si_n2000.json")


def phase_main(dev):
    import torch
    from dgp_tpu_torch import dgp, emulator, layers_from_numpy, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    params = _params_json()
    X, Y = bench_data()
    nb_seed(123)
    cv.reset_launch_counts()
    t0 = time.perf_counter()
    m = dgp(X, Y, layers_from_numpy(params["layers"]), vecchia=True, m=M_TRAIN,
            device=dev)
    torch.cuda.synchronize()
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    emu = emulator(m.estimate(), N=5, device=dev)
    torch.cuda.synchronize()
    t_emu = time.perf_counter() - t0
    z = np.linspace(-1, 1, 1000).reshape(-1, 1)
    mu, var = emu.predict(z, m=50)
    rmse = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    zp = np.linspace(-1, 1, 20000).reshape(-1, 1)
    t0 = time.perf_counter()
    mu_p, var_p = emu.predict(zp, m=50)
    t_pred = time.perf_counter() - t0
    launches = launch_counts()
    gate = 2.0 * params["emulator"]["rmse_gate_ref"]
    checks = {
        "launches": launches["cond_weights_t"] > 0
        and launches["block_loglik_multi_t"] > 0,
        "shapes": mu.shape == (1000, 1) and var.shape == (1000, 1)
        and mu_p.shape == (20000, 1) and var_p.shape == (20000, 1),
        "finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                       and np.isfinite(mu_p).all() and np.isfinite(var_p).all()),
        "variance_positive": bool((var > 0).all() and (var_p > 0).all()),
        "rmse": bool(np.isfinite(rmse) and rmse <= gate),
    }
    emit({"phase": "main", "n": N_TRAIN, "m": M_TRAIN, "N": 5, "dtype": "float64",
          "dgp_construct_s": t_dgp, "emulator_build_s": t_emu, "rmse": rmse,
          "rmse_gate": gate, "rmse_jax_ref": params["emulator"]["rmse_gate_ref"],
          "predict_20000_s": t_pred, "predict_pts_per_s": len(zp) / t_pred,
          "launches": launches, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"main path checks failed: {checks}")
    return launches


def design_data(p):
    """(X, Y, candidates, added-point noise, test points) of the design
    phase's protocol (tools/make_torch_design_params.py:data)."""
    X, Y = bench_data()
    cand = np.random.RandomState(p["cand_seed"]).uniform(-1, 1, (p["n_cand"], 1))
    noise = p["add_noise_sd"] * np.random.RandomState(p["add_noise_seed"]).randn(p["n_add"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    return X, Y, cand, noise, z


def _close_rel(a, b, rtol):
    """(max relative difference, whether every value is within rtol of b's,
    or within rtol of b's largest magnitude where b's value is near 0)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    diff = np.abs(a - b)
    rel = float(np.max(diff / np.maximum(np.abs(b), 1e-300)))
    return rel, bool(np.all(diff <= rtol * np.maximum(np.abs(b), 1e-3 * np.max(np.abs(b)))))


def phase_design(dev):
    """One sequential-design step of a DGP user at the main path's width,
    under the protocol of dgp_tpu_torch/data/design_n2000.json: emulator,
    ALM/MICE/VIGF against a CPU copy of the same imputations, update_xy with
    the 40 best ALM candidates, retraining, emulator, predict, LOO,
    sampling, full_layer, write/read and summary."""
    import contextlib
    import copy
    import io
    import tempfile

    import torch
    from dgp_tpu_torch import (dgp, emulator, layers_from_numpy, nb_seed, read, summary,
                               write)
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    ref = _data_json("design_n2000.json")
    p = ref["protocol"]
    X, Y, cand, noise, z = design_data(p)
    out, checks = {}, {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    cv.reset_launch_counts()
    nb_seed(p["seeds"][0])
    m = dgp(X, Y, layers_from_numpy(_params_json()["layers"]), vecchia=True, m=p["m"],
            device=dev)
    emu, out["emulator_s"] = timed(lambda: emulator(m.estimate(), N=p["emulator_N"],
                                                    device=dev))
    emu_cpu = emulator.from_imputations(copy.deepcopy(emu.all_layer_set), device="cpu")
    scores = {}
    for meth in ("ALM", "MICE", "VIGF"):
        s_card, secs = timed(lambda: emu.metric(cand, method=meth, obj=m, m=p["metric_m"],
                                                score_only=True))
        s_cpu = emu_cpu.metric(cand, method=meth, obj=m, m=p["metric_m"], score_only=True)
        rel, ok = _close_rel(s_card, s_cpu, DESIGN_RTOL)
        scores[meth] = s_card
        out[meth] = {"seconds": secs, "index": int(np.argmax(s_card[:, 0])),
                     "index_cpu": int(np.argmax(s_cpu[:, 0])),
                     "jax_index": ref["jax"]["by_seed"][str(p["seeds"][0])][meth]["index"],
                     "max_rel_vs_cpu": rel}
        checks[f"{meth}_vs_cpu"] = ok and out[meth]["index"] == out[meth]["index_cpu"]
    add = np.argsort(-scores["ALM"][:, 0], kind="stable")[:p["n_add"]]
    X2 = np.vstack([X, cand[add]])
    Y2 = np.vstack([Y, func(cand[add]) + noise])
    before = launch_counts()
    _, out["update_xy_s"] = timed(lambda: m.update_xy(X2, Y2))
    after_update = launch_counts()
    _, out["train_s"] = timed(lambda: m.train(N=p["train_N"], chunk_size=p["chunk_size"],
                                              disable=True))
    after_train = launch_counts()
    out["launches_update_xy"] = {k: after_update[k] - before[k] for k in SOURCES}
    out["launches_per_sem_iteration"] = {k: (after_train[k] - after_update[k]) / p["train_N"]
                                         for k in SOURCES}
    emu2, out["emulator_after_s"] = timed(lambda: emulator(m.estimate(), N=p["emulator_N"],
                                                           device=dev))
    (mu, var), out["predict_s"] = timed(lambda: emu2.predict(z, m=p["pred_m"]))
    out["rmse"] = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    (lm, lv), out["loo_s"] = timed(lambda: emu2.loo(X2, m=p["loo_m"]))
    out["loo_rmse"] = float(np.sqrt(np.mean((lm - Y2) ** 2)))
    np.random.seed(p["seeds"][0])
    (draws,), out["sampling_s"] = timed(lambda: emu2.predict(
        z, method="sampling", sample_size=DESIGN_DRAWS, m=p["pred_m"]))
    (mu_l, var_l), out["full_layer_s"] = timed(lambda: emu2.predict(z, m=p["pred_m"],
                                                                   full_layer=True))
    S = draws.shape[1]
    se = np.sqrt(var[:, 0] / S)
    out["sampling_within_4se"] = float(np.mean(np.abs(draws.mean(axis=1) - mu[:, 0])
                                               <= 4 * se))
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "emulator")
        _, out["write_s"] = timed(lambda: write(emu2, path))
        back_card = read(path, device=dev)
        back_cpu = read(path, device="cpu")
    mu_c, var_c = back_card.predict(z, m=p["pred_m"])
    mu_h, var_h = back_cpu.predict(z, m=p["pred_m"])
    out["read_cpu_max_rel"] = max(_close_rel(mu_h, mu, 1e-9)[0], _close_rel(var_h, var, 1e-9)[0])
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        summary(m)
        summary(emu2)
    out["summary_lines"] = len(text.getvalue().splitlines())
    launches = launch_counts()
    plain = {k: c["plain_calls"] for k, c in cv.launch_counts().items()}
    gate_rmse = DESIGN_FACTOR * ref["jax"]["rmse_median"]
    gate_loo = DESIGN_FACTOR * ref["jax"]["loo_rmse_median"]
    finite = all(bool(np.isfinite(a).all()) for a in
                 [mu, var, lm, lv, draws, *mu_l, *var_l, *scores.values()]
                 + [nd.output for layer in m.all_layer for nd in layer]
                 + [nd.para_path for layer in m.all_layer for nd in layer])
    checks.update({
        "launches": all(out["launches_update_xy"][k] > 0
                        for k in ("block_loglik_multi_t", "cond_weights_t"))
        and all(out["launches_per_sem_iteration"][k] > 0
                for k in ("block_nllik_grad_parts_t", "block_loglik_multi_t",
                          "cond_weights_t")),
        "no_plain_calls": not any(plain.values()),
        "n_after": m.n_data == p["n"] + p["n_add"]
        and all(nd.NNarray.shape == (m.n_data, p["m"] + 1) for layer in m.all_layer
                for nd in layer),
        "finite": finite,
        "rmse": out["rmse"] <= gate_rmse,
        "loo_rmse": out["loo_rmse"] <= gate_loo,
        "sampling": out["sampling_within_4se"] >= 0.99 and draws.shape == (len(z), S)
        and S == p["emulator_N"] * DESIGN_DRAWS,
        "full_layer": len(mu_l) == 2 and np.array_equal(mu_l[-1], mu),
        "read_card_equal": bool(np.array_equal(mu_c, mu) and np.array_equal(var_c, var)),
        "read_cpu_close": out["read_cpu_max_rel"] <= 1e-9,
        "summary": out["summary_lines"] >= 6,
    })
    emit({"phase": "design", "n": p["n"], "n_after": int(m.n_data), "m": p["m"],
          "N": p["emulator_N"], "n_cand": p["n_cand"], "dtype": "float64", **out,
          "rmse_gate": gate_rmse, "loo_rmse_gate": gate_loo,
          "rmse_jax_median": ref["jax"]["rmse_median"],
          "loo_rmse_jax_median": ref["jax"]["loo_rmse_median"], "launches": launches,
          "plain_calls": plain, "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"design phase checks failed: {checks}")
    return launches


def _bench_layers():
    """bench.py's starting structure: length 0.5, nugget 1e-4; layer 2
    wired to the global input with its nugget and scale estimated."""
    from dgp_tpu_torch import combine, kernel
    return combine([kernel(length=np.array([0.5]), name='sexp', nugget=1e-4)],
                   [kernel(length=np.array([0.5]), name='sexp', nugget=1e-4,
                           nugget_est=True, scale_est=True, connect=np.arange(1))])


def phase_train(dev):
    import torch
    from dgp_tpu_torch import dgp, emulator, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    params = _params_json()
    X, Y = bench_data()
    nb_seed(123)
    cv.reset_launch_counts()
    m = dgp(X, Y, _bench_layers(), vecchia=True, m=M_TRAIN, device=dev)
    m.train(N=TRAIN_WARM, disable=True, chunk_size=16)
    torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    m.train(N=TRAIN_TIMED, disable=True, chunk_size=16)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    per_iter = {k: (v - before[k]) / TRAIN_TIMED for k, v in launch_counts().items()}
    est = m.estimate()
    emu = emulator(est, N=5, device=dev)
    z = np.linspace(-1, 1, 1000).reshape(-1, 1)
    mu, var = emu.predict(z, m=50)
    rmse = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    launches = launch_counts()
    trained = [{"scale": float(nd.scale[0]), "length": nd.length.tolist(),
                "nugget": float(nd.nugget[0])} for layer in est for nd in layer]
    jax_trained = [{"scale": nd["scale"], "length": nd["length"],
                    "nugget": nd["nugget"]} for layer in params["layers"] for nd in layer]
    gate = 2.0 * params["emulator"]["rmse_gate_ref"]
    finite = (all(np.isfinite(nd.para_path).all() for layer in m.all_layer
                  for nd in layer)
              and all(np.isfinite(nd.output).all() for layer in m.all_layer[:-1]
                      for nd in layer)
              and bool(np.isfinite(mu).all() and np.isfinite(var).all()))
    checks = {
        "launches": all(launches[k] > 0 for k in ("block_nllik_grad_parts_t",
                                                  "block_loglik_multi_t",
                                                  "cond_weights_t")),
        "iterations": m.N == TRAIN_WARM + TRAIN_TIMED
        and all(len(nd.para_path) == 1 + m.N for layer in m.all_layer for nd in layer),
        "finite": finite,
        "rmse": bool(np.isfinite(rmse) and rmse <= gate),
    }
    emit({"phase": "train", "n": N_TRAIN, "m": M_TRAIN, "dtype": "float64",
          "iterations": m.N, "timed_iterations": TRAIN_TIMED,
          "sem_it_per_s": TRAIN_TIMED / t_train, "timed_s": t_train,
          "trained": trained, "jax_trained": jax_trained,
          "rmse": rmse, "rmse_gate": gate, "launches": launches,
          "launches_per_iteration": per_iter, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"train phase checks failed: {checks}")
    return launches


def phase_nodewise(dev):
    import torch
    from dgp_tpu_torch import dgp, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    X, Y = bench_data()
    nb_seed(123)
    cv.reset_launch_counts()
    t0 = time.perf_counter()
    m = dgp(X, Y, _bench_layers(), vecchia=True, m=M_TRAIN, block=False, device=dev)
    torch.cuda.synchronize()
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.train(N=NODEWISE_ITERS, disable=True, chunk_size=16)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = launch_counts()
    checks = {
        "launches": launches["block_loglik_parts_t"] > 0,
        "finite": all(np.isfinite(nd.para_path).all() for layer in m.all_layer
                      for nd in layer)
        and all(np.isfinite(nd.output).all() for layer in m.all_layer[:-1]
                for nd in layer),
        "iterations": m.N == NODEWISE_ITERS,
    }
    emit({"phase": "nodewise", "n": N_TRAIN, "m": M_TRAIN, "block": False,
          "dgp_construct_s": t_dgp, "train_s": t_train,
          "sem_it_per_s": NODEWISE_ITERS / t_train, "launches": launches,
          "para_last": [nd.para_path[-1].tolist() for layer in m.all_layer
                        for nd in layer],
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"nodewise phase checks failed: {checks}")
    return launches


def phase_gp(dev):
    import torch
    from dgp_tpu_torch import gp, kernel, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    ref = _data_json("gp_n2000.json")
    p, jax_res = ref["protocol"], ref["jax"]
    X, Y = bench_data()
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    zp = np.linspace(-1, 1, N_PRED).reshape(-1, 1)
    cand = np.random.RandomState(p["cand_seed"]).uniform(-1, 1, (p["n_cand"], 1))
    nb_seed(123)
    cv.reset_launch_counts()

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    k = kernel(length=np.array([p["length"]]), name=p["kernel"], nugget=p["nugget"],
               scale_est=p["scale_est"], nugget_est=p["nugget_est"])
    m, t_build = timed(lambda: gp(X, Y, k, device=dev))
    _, t_train = timed(m.train)
    (mu, var), _ = timed(lambda: m.predict(z))
    rmse = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    (mu_p, var_p), t_pred = timed(lambda: m.predict(zp))
    (lm, lv), t_loo = timed(m.loo)
    picks, finite = {}, []
    for meth in ("ALM", "MICE", "VIGF"):
        (idx, val), t_m = timed(lambda: m.metric(cand, method=meth))
        picks[meth] = {"index": int(np.ravel(idx)[0]), "value": float(np.ravel(val)[0]),
                       "jax_index": jax_res["dense"][meth]["index"], "seconds": t_m}
        finite.append(np.isfinite(val).all())
    dense = {"train_s": t_train, "build_s": t_build, "rmse": rmse,
             "rmse_gate": 2.0 * jax_res["dense"]["rmse"],
             "predict_20000_s": t_pred, "predict_pts_per_s": N_PRED / t_pred,
             "loo_s": t_loo, "loo_rmse": float(np.sqrt(np.mean((lm - Y) ** 2))),
             "scale": float(m.kernel.scale[0]), "length": m.kernel.length.tolist(),
             "nugget": float(m.kernel.nugget[0]), "metric": picks}
    launches_dense = launch_counts()
    np.random.seed(p["vecchia_ord_seed"])
    m.to_vecchia(m=p["vecchia_m"])
    before = launch_counts()
    _, t_vtrain = timed(m.train)
    after_train = launch_counts()
    ll, t_ll = timed(m.kernel.log_likelihood_func)
    after_ll = launch_counts()
    (mu_v, var_v), _ = timed(lambda: m.predict(z, m=p["pred_m"]))
    rmse_v = float(np.sqrt(np.mean((mu_v - func(z)) ** 2)))
    (mu_vp, var_vp), t_vpred = timed(lambda: m.predict(zp, m=p["pred_m"]))
    k1 = "block_nllik_grad_parts_t"
    k4 = "block_loglik_parts_t"
    ordering = bool(np.array_equal(m.kernel.ord, gp_order(p)))
    vecch = {"train_s": t_vtrain, "log_likelihood": ll, "log_likelihood_s": t_ll,
             "jax_log_likelihood": jax_res["vecchia"]["log_likelihood"],
             "K1_launches_per_train": after_train[k1] - before[k1],
             "K4_launches_per_log_likelihood": after_ll[k4] - after_train[k4],
             "rmse": rmse_v, "rmse_gate": 2.0 * jax_res["vecchia"]["rmse"],
             "predict_20000_s": t_vpred, "predict_pts_per_s": N_PRED / t_vpred,
             "scale": float(m.kernel.scale[0]), "length": m.kernel.length.tolist(),
             "nugget": float(m.kernel.nugget[0])}
    launches = launch_counts()
    arrays = (mu, var, mu_p, var_p, lm, lv, mu_v, var_v, mu_vp, var_vp)

    def params_close(ours, jax_ref):
        return all(np.allclose(np.atleast_1d(ours[k]), np.atleast_1d(jax_ref[k]),
                               rtol=GP_RTOL_PARAMS, atol=0.0)
                   for k in ("scale", "length", "nugget"))
    checks = {
        "dense_no_kernels": not any(launches_dense.values()),
        "launches": vecch["K1_launches_per_train"] > 0
        and vecch["K4_launches_per_log_likelihood"] > 0,
        "shapes": mu.shape == (p["n_test"], 1) and mu_p.shape == (N_PRED, 1)
        and lm.shape == (N_TRAIN, 1) and mu_vp.shape == (N_PRED, 1),
        "finite": bool(all(np.isfinite(a).all() for a in arrays) and all(finite)
                       and np.isfinite(ll)),
        "variance_positive": bool(all((v > 0).all() for v in (var, var_p, lv, var_v))),
        "rmse": rmse <= dense["rmse_gate"] and rmse_v <= vecch["rmse_gate"],
        "params_vs_jax": params_close(dense, jax_res["dense"])
        and params_close(vecch, jax_res["vecchia"]),
        "log_likelihood_vs_jax": bool(np.isclose(ll, jax_res["vecchia"]["log_likelihood"],
                                                 rtol=GP_RTOL_LL, atol=0.0)),
        "metric_picks": all(v["index"] == v["jax_index"] for v in picks.values()),
        "ordering": ordering,
    }
    emit({"phase": "gp", "n": N_TRAIN, "dtype": "float64", "dense": dense,
          "vecchia": vecch, "jax": jax_res, "launches": launches, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"gp phase checks failed: {checks}")
    return launches


def run_dense_dgp(_=None):
    """The `dense_dgp` phase on the current card, in a worker process of
    `phase_host_bound`: its record, with its checks and kernel launches."""
    import torch
    from dgp_tpu_torch import combine, dgp, emulator, kernel, nb_seed
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)

    t_phase = time.perf_counter()
    X, Y, z, truth = twod_data()
    nb_seed(99)

    def k(**kw):
        return kernel(length=np.array([1]), name='sexp', **kw)

    all_layer = combine([k(), k()], [k(connect=np.arange(2)), k(connect=np.arange(2))],
                        [k(connect=np.arange(2)), k(connect=np.arange(2))],
                        [k(scale_est=True, connect=np.arange(2))])
    t0 = time.perf_counter()
    m = dgp(X, [Y], all_layer, device=dev)
    torch.cuda.synchronize()
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.train(N=TWOD_TRAIN, disable=True)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    emu = emulator(m.estimate(), N=TWOD_IMPUTATIONS, device=dev)
    torch.cuda.synchronize()
    t_emu = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, var = emu.predict(z)
    t_pred = time.perf_counter() - t0
    rmse = float(np.sqrt(np.mean((mu.flatten() - truth.flatten()) ** 2)))
    launches = launch_counts()
    checks = {
        **_dense_checks(launches),
        "iterations": m.N == TWOD_TRAIN
        and all(len(nd.para_path) == 1 + m.N for layer in m.all_layer for nd in layer),
        "finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                       and all(np.isfinite(nd.para_path).all() for layer in m.all_layer
                               for nd in layer)),
        "variance_positive": bool((var > 0).all()),
        "rmse": rmse <= TWOD_GATE,
    }
    return {"phase": "dense_dgp", "config": "parity 2d", "n": len(X), "layers": [2, 2, 2, 1],
            "dgp_construct_s": t_dgp, "train_s": t_train,
            "sem_it_per_s": TWOD_TRAIN / t_train, "emulator_build_s": t_emu,
            "predict_100_s": t_pred, "rmse_vs_truth_diag": rmse, "rmse_gate": TWOD_GATE,
            "launches": launches, "checks": checks,
            "seconds": time.perf_counter() - t_phase}


def phase_ref(dev):
    import torch
    from dgp_tpu_torch import combine, dgp, kernel, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    X, Y = bench_data()
    nb_seed(123)
    cv.reset_launch_counts()
    layers = combine([kernel(length=np.array([0.5]), name='sexp', nugget=1e-4,
                             prior_name='ref')],
                     [kernel(length=np.array([0.5]), name='sexp', nugget=1e-4,
                             nugget_est=True, scale_est=True, connect=np.arange(1),
                             prior_name='ref')])
    t0 = time.perf_counter()
    m = dgp(X, Y, layers, vecchia=True, m=M_TRAIN, device=dev)
    torch.cuda.synchronize()
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.train(N=REF_ITERS, disable=True, chunk_size=16)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    launches = launch_counts()
    checks = {
        "launches": all(launches[k] > 0 for k in ("block_nllik_grad_parts_t",
                                                  "cond_weights_t",
                                                  "block_loglik_parts_t"))
        and launches["block_loglik_multi_t"] == 0,
        "finite": all(np.isfinite(nd.para_path).all() for layer in m.all_layer
                      for nd in layer)
        and all(np.isfinite(nd.output).all() for layer in m.all_layer[:-1]
                for nd in layer),
        "iterations": m.N == REF_ITERS,
    }
    emit({"phase": "ref", "n": N_TRAIN, "m": M_TRAIN, "prior": "ref",
          "dgp_construct_s": t_dgp, "train_s": t_train,
          "sem_it_per_s": REF_ITERS / t_train, "launches": launches,
          "prior_coef": [nd.prior_coef.tolist() for layer in m.all_layer for nd in layer],
          "para_last": [nd.para_path[-1].tolist() for layer in m.all_layer
                        for nd in layer],
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"ref phase checks failed: {checks}")
    return launches


def _gate_formula_rows(torch, cv):
    """`cv.shared_bytes` (the gate's Python formula) against the library's
    `launch_plan` at shapes below and above the 48 KB a launch gets without
    opting in, and at the last d inside the SM's 227 KB and the first d
    beyond it, at m1 = 32 (one row per lane) and at m1 = 33, 48 and 64 (two
    rows per lane), where the plan must fail as the gate says."""
    rows, ok = [], True
    for kname, kid in cv.KERNEL_ID.items():
        for dt in (torch.float64, torch.float32):
            for m1, d in ((26, 2), (32, 1), (2, 5), (32, 100), (17, 300), (41, 2), (64, 2),
                          (64, 40)):
                plan = cv.launch_plan(kname, dt, m1, d)["shared_bytes"]
                mine = cv.shared_bytes(kid, m1, d, dt)
                ok &= plan == mine and cv.use_kernel(kid, m1, d, dt)
                rows.append([kid, str(dt), m1, d, plan, mine])
            for m1 in (32, 33, 48, 64):
                d = 1
                while cv.use_kernel(kid, m1, d + 1, dt):
                    d += 1
                inside = cv.launch_plan(kname, dt, m1, d)["shared_bytes"]
                try:
                    cv.launch_plan(kname, dt, m1, d + 1)
                    beyond = "planned"
                except RuntimeError:
                    beyond = "refused"
                ok &= inside == cv.shared_bytes(kid, m1, d, dt) and beyond == "refused"
                rows.append([kid, str(dt), m1, d, inside, "last inside; d+1 " + beyond])
    return rows, ok


def gate_gp_data(n=GATE_GP_N):
    """The gate phase's gp on 12 inputs: n (300) points of [0, 1]^12, a sum
    of one smooth term per input plus noise (sd 0.05)."""
    rs = np.random.RandomState(GATE_GP_SEED)
    X = rs.rand(n, GATE_GP_D)
    w = np.linspace(0.5, 3.0, GATE_GP_D)
    Y = np.sin(X * w).sum(axis=1, keepdims=True) + 0.05 * rs.randn(n, 1)
    return X, Y


def _upper_loglik(m, dev):
    """The upper log-likelihood of a trained model's state on the card and
    on a CPU engine carrying the same state."""
    from dgp_tpu_torch.interop import layers_from_numpy, layers_to_numpy
    from dgp_tpu_torch.models.compiled import CompiledDGP
    lls = []
    for device in (dev, "cpu"):
        eng = CompiledDGP(layers_from_numpy(layers_to_numpy(m.all_layer)), device=device)
        lat, par = eng.get_state()
        lls.append(float(eng._upper_loglik(0, lat, par, eng.get_nn_state())))
    return lls


def _route_times(dev, X, Y):
    """Milliseconds per call of the large-block route at n = 2000 on the
    main path's data (ordered by a fixed permutation, exact neighbours of
    the inputs scaled by bench.py's lengthscale 0.5, nugget 1e-4): the
    log-likelihood (K4's bound), the conditional weights (K3's) and the
    M-step objective with its gradient (K1's), at each m of
    ROUTE_TIMED_M."""
    import torch
    from dgp_tpu_torch.vecchia import core as vcore
    from dgp_tpu_torch.vecchia import nn as vnn
    o = np.random.RandomState(0).permutation(N_TRAIN)
    f64 = dict(dtype=torch.float64, device=dev)
    Xo, yo = torch.as_tensor(X[o], **f64), torch.as_tensor(Y[o, 0], **f64)
    length, nugget = torch.tensor([0.5], **f64), 1e-4
    nd = torch.ones(N_TRAIN, **f64)
    lt = torch.log(torch.tensor([0.5, nugget], **f64))
    out = {}
    for m in ROUTE_TIMED_M:
        NN = torch.as_tensor(vnn.nn(X[o] / 0.5, m, device=dev), device=dev)
        kw = dict(name="sexp", n_length=1, scale_est=True, nugget_est=True,
                  fixed_scale=1.0, fixed_nugget=nugget, n_orig=N_TRAIN, sum_residual=None)
        calls = {
            "K4_vecchia_llik": lambda: vcore.vecchia_llik(Xo, yo, NN, 1.0, length, nugget,
                                                          nd, "sexp"),
            "K3_cond_weights": lambda: vcore.cond_weights(Xo, NN, length, nugget, "sexp"),
            "K1_vecchia_nllik_fg": lambda: vcore.vecchia_nllik_fg(lt, Xo, yo, NN, nd, **kw),
        }
        vcore.reset_route_counts()
        out[f"m{m}"] = {k: cuda_ms(fn, reps=5, warm=1, inner=2) for k, fn in calls.items()}
        out[f"m{m}"]["route_calls"] = vcore.route_counts()
        out[f"m{m}"]["calls_each"] = 1 + 5 * 2
    return out


def phase_gate(dev):
    import torch
    from dgp_tpu_torch import dgp, emulator, gp, kernel, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.vecchia import core as vcore

    t_phase = time.perf_counter()
    formula_rows, formula_ok = _gate_formula_rows(torch, cv)
    X, Y = bench_data()
    z = np.linspace(-1, 1, 1000).reshape(-1, 1)
    # outside the bound (m1 = 65): the large-block route of vecchia.core, as
    # dgp_tpu's XLA branch; no kernel launched and no plain version run but
    # K6, whose prediction blocks at m = 50 are inside its bound
    nb_seed(123)
    cv.reset_launch_counts()
    vcore.reset_route_counts()
    t0 = time.perf_counter()
    mo = dgp(X, Y, _bench_layers(), vecchia=True, m=GATE_M_OUTSIDE, device=dev)
    mo.train(N=GATE_ITERS, disable=True, chunk_size=16)
    mu_o, var_o = emulator(mo.estimate(), N=2, device=dev).predict(z, m=50)
    torch.cuda.synchronize()
    seconds_o = time.perf_counter() - t0
    counts_o, routes_o = cv.launch_counts(), vcore.route_counts()
    lls_o = _upper_loglik(mo, dev)
    # a wrapper called directly outside its bound still refuses on the card
    rs = np.random.RandomState(0)
    f64 = dict(dtype=torch.float64, device=dev)
    Xg = torch.as_tensor(rs.rand(GATE_M_OUTSIDE + 1, 2, 8), **f64)
    yg = torch.as_tensor(rs.rand(GATE_M_OUTSIDE + 1, 8), **f64)
    try:
        cv.block_loglik_parts_t(Xg, yg, 1.1 + 0 * yg, name="sexp")
        refusal = None
    except NotImplementedError as e:
        refusal = str(e)
    outside = {"seconds": seconds_o, "counts": counts_o, "route_calls": routes_o,
               "use_kernel": {kid: cv.use_kernel(kid, GATE_M_OUTSIDE + 1, 2)
                              for kid in cv.KERNEL_ID.values()},
               "upper_loglik_card": lls_o[0], "upper_loglik_cpu": lls_o[1],
               "rmse": float(np.sqrt(np.mean((mu_o - func(z)) ** 2))),
               "finite": bool(np.isfinite(mu_o).all() and np.isfinite(var_o).all()
                              and all(np.isfinite(nd.para_path).all()
                                      for layer in mo.all_layer for nd in layer)),
               "wrapper_refusal": refusal,
               "route_ms_n2000": _route_times(dev, X, Y)}
    # m = 40 (m1 = 41): two rows per lane, through the kernels
    nb_seed(123)
    cv.reset_launch_counts()
    vcore.reset_route_counts()
    t0 = time.perf_counter()
    m = dgp(X, Y, _bench_layers(), vecchia=True, m=GATE_M, device=dev)
    torch.cuda.synchronize()
    t_sem = time.perf_counter()
    m.train(N=GATE_ITERS, disable=True, chunk_size=16)
    torch.cuda.synchronize()
    sem_s = (time.perf_counter() - t_sem) / GATE_ITERS
    mu, var = emulator(m.estimate(), N=2, device=dev).predict(z, m=50)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = cv.launch_counts()
    launches = {k: c["launches"] for k, c in counts.items()}
    routes_in = vcore.route_counts()
    lls = _upper_loglik(m, dev)
    inside = {"launches": launches, "seconds": seconds, "sem_seconds_per_iteration": sem_s,
              "route_calls": routes_in,
              "plain_calls": {k: c["plain_calls"] for k, c in counts.items()},
              "angle_applicable": m.imp._engine()._angle_applicable(0),
              "upper_loglik_card": lls[0], "upper_loglik_cpu": lls[1],
              "rmse": float(np.sqrt(np.mean((mu - func(z)) ** 2))),
              "finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                             and all(np.isfinite(nd.para_path).all()
                                     for layer in m.all_layer for nd in layer))}
    # a Vecchia gp with one lengthscale per input on 12 inputs: K1 takes its
    # 12 length lanes; trained on the card and on the CPU
    Xg, Yg = gate_gp_data()
    gps = {}
    for device in (dev, "cpu"):
        np.random.seed(GATE_GP_SEED)
        cv.reset_launch_counts()
        t0 = time.perf_counter()
        g = gp(Xg, Yg, kernel(length=np.full(GATE_GP_D, 0.5), name="sexp", scale_est=True,
                              nugget_est=True), vecchia=True, m=M_TRAIN, device=device)
        g.train()
        gps[str(device)] = {"seconds": time.perf_counter() - t0,
                            "K1_launches": launch_counts()["block_nllik_grad_parts_t"],
                            "scale": float(g.kernel.scale[0]),
                            "length": g.kernel.length.tolist(),
                            "nugget": float(g.kernel.nugget[0])}
    gcard, gcpu = gps[str(dev)], gps["cpu"]
    checks = {
        "shared_bytes_formula": formula_ok,
        "outside_route": not any(outside["use_kernel"].values())
        and all(routes_o[k] > 0 for k in ("K1", "K3", "K4")),
        "outside_no_kernel_no_plain": all(c == {"launches": 0, "plain_calls": 0}
                                          for k, c in counts_o.items()
                                          if k != "vecchia_pred_t"),
        "outside_loglik_card_vs_cpu": bool(np.isclose(lls_o[0], lls_o[1], rtol=GATE_RTOL,
                                                      atol=0.0)),
        "outside_finite": outside["finite"],
        "outside_wrapper_refused": refusal is not None
        and f"m1={GATE_M_OUTSIDE + 1}" in refusal,
        "route_timed": all(v["route_calls"] == {k: v["calls_each"] for k in ("K1", "K3", "K4")}
                           for v in outside["route_ms_n2000"].values()),
        "inside_no_route": not any(routes_in.values()),
        "inside_launches": inside["angle_applicable"] and all(
            launches[k] > 0 for k in ("block_nllik_grad_parts_t",
                                      "block_loglik_multi_t", "cond_weights_t")),
        "inside_no_plain_calls": not any(inside["plain_calls"].values()),
        "loglik_card_vs_cpu": bool(np.isclose(lls[0], lls[1], rtol=GATE_RTOL, atol=0.0)),
        "finite": inside["finite"],
        "gp12_K1_launches": gcard["K1_launches"] > 0 and len(gcard["length"]) == GATE_GP_D,
        "gp12_card_vs_cpu": all(np.allclose(np.atleast_1d(gcard[k]), np.atleast_1d(gcpu[k]),
                                            rtol=GP_RTOL_PARAMS, atol=0.0)
                                for k in ("scale", "length", "nugget")),
    }
    emit({"phase": "gate", "n": N_TRAIN, "iterations": GATE_ITERS,
          "m_outside": GATE_M_OUTSIDE, "outside": outside, "m_inside": GATE_M,
          "inside": inside, "gp12": gps, "shared_bytes_rows": formula_rows,
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"gate phase checks failed: {checks}")
    return launches


def _branin_torch(x2d):
    """Branin as a torch objective for multistart (its negative; minimum
    0.397887)."""
    import torch
    x, y = x2d[:, 0], x2d[:, 1]
    a, b, c, r, s, t = 1, 5.1 / (4 * np.pi**2), 5 / np.pi, 6, 10, 1 / (8 * np.pi)
    val = a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s
    return (-val).reshape(-1, 1)


def _models_equal(ma, mb):
    """Hyper-parameter paths, latents and R^2 of two trained dgps equal bit
    for bit."""
    return all(np.array_equal(a.para_path, b.para_path) and np.array_equal(a.output, b.output)
               and (a.R2 is None or np.array_equal(a.R2, b.R2))
               for la, lb in zip(ma.all_layer, mb.all_layer) for a, b in zip(la, lb)
               if a.type == "gp")


def _sem_pair(build, iters, profiled):
    """`train` and `ptrain` (on the mesh the caller set) of two models that
    `build` makes alike: ``iters`` timed SEM iterations, then ``profiled``
    more under torch.profiler, for the host reads (device-to-host copies)
    and synchronisations per iteration and the kernel launches per
    iteration by card.  Returns (rows, the models)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    rows, models = {}, {}
    for how in ("train", "ptrain"):
        m = build()
        _, t = _timed(lambda: getattr(m, how)(N=iters, disable=True))
        models[how] = m
        before, cards = cv.launch_counts(), cv.launch_counts_by_device()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            getattr(m, how)(N=profiled, disable=True)
            torch.cuda.synchronize()
        after, cards_after = cv.launch_counts(), cv.launch_counts_by_device()
        ev = prof.key_averages()
        rows[how] = {
            "seconds": t,
            "host_reads_per_iteration": sum(e.count for e in ev if "DtoH" in e.key)
            / profiled,
            "syncs_per_iteration": sum(e.count for e in ev if e.key in (
                "cudaStreamSynchronize", "cudaDeviceSynchronize")) / profiled,
            "launches_per_iteration": {
                k: (after[k]["launches"] - before[k]["launches"]) / profiled for k in after},
            "launches_per_iteration_by_card": {
                k: {d: (c - cards[k].get(d, 0)) / profiled
                    for d, c in cards_after[k].items()} for k in after}}
    return rows, models


def phase_parallel(dev):
    import warnings
    import torch
    from dgp_tpu_torch import (container, dgp, emulator, gp, kernel, layers_from_numpy,
                               lgp, nb_seed, utils)
    from dgp_tpu_torch.ops import cuda_vecchia as cv
    from dgp_tpu_torch.parallel import mesh as pmesh

    t_phase = time.perf_counter()
    params = _params_json()
    X, Y = bench_data()
    # a model built with device='cuda' (no index) has the visible cards'
    # mesh, each card once
    real_mesh = pmesh.model_mesh
    mesh = real_mesh("cuda")
    # the split's mesh: every card, or on one card two shares of it
    split_mesh = mesh if torch.cuda.device_count() > 1 else (dev, dev)
    cv.reset_launch_counts()

    def same(a, b):
        return all(np.array_equal(u, v) for u, v in zip(a, b))

    pmesh.model_mesh = lambda device: split_mesh
    try:
        # ptrain (device='cuda') against a twin's train (cuda:0) from the
        # same nb_seed, at the main path's n = 2000 and at large_n's 1e5
        def build_main():
            nb_seed(123)
            return dgp(X, Y, layers_from_numpy(params["layers"]), vecchia=True, m=M_TRAIN,
                       device="cuda")
        sem, models = _sem_pair(build_main, PARALLEL_ITERS, PARALLEL_PROFILED)
        mp, mt = models["ptrain"], models["train"]
        lp_ = _data_json("large_n1e5.json")["protocol"]
        XL, YL = large_data(lp_)

        def build_large():
            nb_seed(lp_["dgp_seed"])
            return dgp(XL, YL, _bench_layers(), vecchia=True, m=lp_["dgp_m"],
                       check_rep=False, device=dev)
        sem_large, models_large = _sem_pair(build_large, PARALLEL_ITERS, PARALLEL_PROFILED)
        large_equal = _models_equal(models_large["ptrain"], models_large["train"])
        del models_large
        # the emulator's p* methods against the one-device calls
        nb_seed(123)
        emu = emulator(mp.estimate(), N=5, device=dev)
        zp = np.linspace(-1, 1, N_PRED).reshape(-1, 1)
        cand = np.random.RandomState(7).uniform(-1, 1, (1000, 1))
        emu.predict(zp, m=50)              # builds the ensemble, grows the pools
        pp, t_pp = _timed(lambda: emu.ppredict(zp, m=50))
        p1, t_p1 = _timed(lambda: emu.predict(zp, m=50))
        pl, t_pl = _timed(lambda: emu.ploo(mp.X, m=30))
        l1, t_l1 = _timed(lambda: emu.loo(mp.X, m=30))
        pm, t_pm = _timed(lambda: emu.pmetric(cand, method="ALM", score_only=True))
        m1, t_m1 = _timed(lambda: emu.metric(cand, method="ALM", score_only=True))
        emulator_rows = {"ppredict_20000_s": t_pp, "predict_20000_s": t_p1, "ploo_s": t_pl,
                         "loo_s": t_l1, "pmetric_alm_s": t_pm, "metric_alm_s": t_m1,
                         "replicas": sorted(emu._ens._replicas)}
        # the gp phase's dense gp
        ref = _data_json("gp_n2000.json")["protocol"]
        g = gp(X, Y, kernel(length=np.array([ref["length"]]), name=ref["kernel"],
                            nugget=ref["nugget"], scale_est=ref["scale_est"],
                            nugget_est=ref["nugget_est"]), device=dev)
        g.train()
        g.predict(zp)                                # first-call work out of the timing
        gpp, t_gpp = _timed(lambda: g.ppredict(zp))
        gp1, t_gp1 = _timed(lambda: g.predict(zp))
        gpm = g.pmetric(cand, method="MICE", score_only=True)
        gm1 = g.metric(cand, method="MICE", score_only=True)
        # lgp on the linked phase's system, one seed
        lref = _data_json("linked_n2000.json")
        lp = lref["protocol"]
        X1, Y1, X2, Y2 = linked_data(lp)
        np.random.seed(lp["gp_ord_seed"])
        g1 = gp(X1, Y1, kernel(length=np.array([lp["gp_length"]]), name=lp["gp_kernel"],
                               scale_est=True, nugget_est=True), vecchia=True, m=lp["m"],
                device=dev)
        g1.train()
        seed = lp["lgp_seeds"][0]
        nb_seed(seed)
        np.random.seed(seed)
        m2 = dgp(X2, Y2, linked_layers(lref), vecchia=True, m=lp["m"], device=dev)
        system = lgp([[container(g1.export(), local_input_idx=np.array([0]), device=dev)],
                      [container(m2.estimate(), local_input_idx=np.array([0]),
                                 device=dev)]], N=lp["lgp_N"], device=dev)
        zl = np.linspace(-1, 1, PARALLEL_LGP_POINTS).reshape(-1, 1)
        system.predict(zl[:4], m=lp["pred_m"])       # first-call work out of the timing
        lpp, t_lpp = _timed(lambda: system.ppredict(zl, m=lp["pred_m"]))
        lp1, t_lp1 = _timed(lambda: system.predict(zl, m=lp["pred_m"]))
    finally:
        pmesh.model_mesh = real_mesh
    # multistart on Branin, all starts in one batched L-BFGS on the card
    inits = np.random.RandomState(9).uniform([-5, 0], [10, 15], (MULTISTART_STARTS, 2))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        best, t_ms = _timed(lambda: utils.multistart(_branin_torch, inits,
                                                     np.array([-5.0, 0.0]),
                                                     np.array([10.0, 15.0]), device=dev))
    best_value = float(-_branin_torch(torch.as_tensor(best[None]))[0, 0])
    ms_warnings = [str(w.message) for w in caught if issubclass(w.category, RuntimeWarning)]
    kernels_split = ("block_nllik_grad_parts_t", "block_loglik_multi_t", "cond_weights_t")

    def launches_split(rows, n):
        shares = len(pmesh.shard_rows(n, split_mesh))
        per = {h: rows[h]["launches_per_iteration"] for h in rows}
        return all(per["train"][k] > 0 and per["ptrain"][k] == shares * per["train"][k]
                   for k in kernels_split)

    def reads_equal(rows):
        return (rows["train"]["host_reads_per_iteration"] > 0
                and rows["ptrain"]["host_reads_per_iteration"]
                == rows["train"]["host_reads_per_iteration"])

    checks = {
        "mesh_names_each_card_once": mesh[0] == dev and len(set(mesh)) == len(mesh)
        == torch.cuda.device_count(),
        "split_mesh": len(split_mesh) == max(2, len(mesh)),
        "ptrain_equals_train": _models_equal(mp, mt)
        and mp.N == mt.N == PARALLEL_ITERS + PARALLEL_PROFILED,
        "ptrain_equals_train_1e5": large_equal,
        "ptrain_launches": launches_split(sem, N_TRAIN)
        and launches_split(sem_large, lp_["n"]),
        "ptrain_host_reads": reads_equal(sem) and reads_equal(sem_large),
        "emulator_ppredict": same(pp, p1) and pp[0].shape == (N_PRED, 1),
        "emulator_ploo": same(pl, l1),
        "emulator_pmetric": np.array_equal(pm, m1),
        "gp_ppredict": same(gpp, gp1),
        "gp_pmetric": np.array_equal(gpm, gm1),
        "lgp_ppredict": all(same(a, b) for a, b in zip(lpp, lp1)),
        "finite": bool(np.isfinite(pp[0]).all() and np.isfinite(lpp[0][0]).all()),
        "multistart": not ms_warnings and best_value < BRANIN_BAR,
    }
    launches = launch_counts()
    emit({"phase": "parallel", "n": N_TRAIN, "m": M_TRAIN, "mesh": [str(d) for d in mesh],
          "split_mesh": [str(d) for d in split_mesh], "sem_iterations": PARALLEL_ITERS,
          "profiled_iterations": PARALLEL_PROFILED,
          "sem_n2000": sem, "sem_n1e5": sem_large,
          "ptrain_s": sem["ptrain"]["seconds"], "train_s": sem["train"]["seconds"],
          "ptrain_1e5_s": sem_large["ptrain"]["seconds"],
          "train_1e5_s": sem_large["train"]["seconds"],
          "emulator": emulator_rows, "gp_ppredict_20000_s": t_gpp,
          "gp_predict_20000_s": t_gp1, "lgp_points": PARALLEL_LGP_POINTS,
          "lgp_ppredict_s": t_lpp, "lgp_predict_s": t_lp1,
          "multistart": {"starts": MULTISTART_STARTS, "seconds": t_ms,
                         "best": best.tolist(), "best_value": best_value,
                         "runtime_warnings": ms_warnings},
          "launches": launches, "launches_by_card": cv.launch_counts_by_device(),
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"parallel phase checks failed: {checks}")
    return launches


def lik_noise_sd(x):
    return 0.05 * np.exp(0.8 * x)


def lik_data(p):
    """The lik_vecchia protocol's data (tools/make_torch_lik_params.py:49-59):
    training data, the test grid and the sorted held-out data."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    Y = func(X) + lik_noise_sd(X) * rng.randn(p["n"], 1)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    rh = np.random.RandomState(p["heldout_seed"])
    Xh = np.sort(rh.rand(p["n_heldout"], 1) * 2 - 1, axis=0)
    Yh = func(Xh) + lik_noise_sd(Xh) * rh.randn(p["n_heldout"], 1)
    return X, Y, z, Xh, Yh


def linked_data(p):
    """The `linked` protocol's data (tools/make_torch_params.py): model 1 on
    f1(x) = (sin 7.5x + 1)/2 over [-1, 1], model 2 on f2 over f1's range
    [0, 1], so that f2(f1(x)) is `func`."""
    rng = np.random.RandomState(p["data_seed"])
    X1 = rng.uniform(-1, 1, (p["n"], 1))
    Y1 = (np.sin(7.5 * X1) + 1) / 2 + p["y1_noise"] * rng.randn(p["n"], 1)
    X2 = rng.uniform(0, 1, (p["n"], 1))
    Y2 = (2 / 3 * np.sin(2 * (2 * X2 - 1)) + 4 / 3 * np.exp(-30 * (2 * (2 * X2 - 1)) ** 2)
          - 1 / 3) + p["y2_noise"] * rng.randn(p["n"], 1)
    return X1, Y1, X2, Y2


def linked_layers(ref):
    """The `linked` protocol's model 2: the main path's structure at the JAX
    package's trained hyper-parameters (``ref``: linked_n2000.json)."""
    from dgp_tpu_torch import combine, kernel
    h1, h2 = ref["dgp"]["layers"]
    return combine([kernel(length=np.array(h1["length"]), scale=h1["scale"],
                           nugget=h1["nugget"], name='sexp')],
                   [kernel(length=np.array(h2["length"]), scale=h2["scale"],
                           nugget=h2["nugget"], name='sexp', nugget_est=True,
                           scale_est=True, connect=np.arange(1))])


def phase_linked(dev):
    import torch
    from dgp_tpu_torch import container, dgp, gp, kernel, lgp, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    ref = _data_json("linked_n2000.json")
    p = ref["protocol"]
    X1, Y1, X2, Y2 = linked_data(p)
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    zp = np.linspace(-1, 1, N_PRED).reshape(-1, 1)

    def counts_since(before):
        return {k: v - before[k] for k, v in launch_counts().items()}

    cv.reset_launch_counts()
    # model 1, trained on the card (K1)
    t0 = time.perf_counter()
    np.random.seed(p["gp_ord_seed"])
    g = gp(X1, Y1, kernel(length=np.array([p["gp_length"]]), name=p["gp_kernel"],
                          scale_est=True, nugget_est=True), vecchia=True, m=p["m"], device=dev)
    g.train()
    torch.cuda.synchronize()
    trained = {"scale": float(g.kernel.scale[0]), "length": g.kernel.length.tolist(),
               "nugget": float(g.kernel.nugget[0]), "train_s": time.perf_counter() - t0,
               "launches": launch_counts()}
    c1 = container(g.export(), local_input_idx=np.array([0]), device=dev)
    runs = []
    for seed in p["lgp_seeds"]:
        t0 = time.perf_counter()
        nb_seed(seed)
        np.random.seed(seed)
        m2 = dgp(X2, Y2, linked_layers(ref), vecchia=True, m=p["m"], device=dev)
        before = launch_counts()
        c2 = container(m2.estimate(), local_input_idx=np.array([0]), device=dev)
        torch.cuda.synchronize()
        t_container = time.perf_counter() - t0
        per_container = counts_since(before)
        before = launch_counts()
        t0 = time.perf_counter()
        system = lgp([[c1], [c2]], N=p["lgp_N"], device=dev)
        torch.cuda.synchronize()
        t_lgp = time.perf_counter() - t0
        per_lgp = counts_since(before)
        t0 = time.perf_counter()
        mu, var = system.predict(z, m=p["pred_m"])
        t_z = time.perf_counter() - t0
        run = {"seed": seed, "dgp_and_container_s": t_container, "lgp_s": t_lgp,
               "predict_1000_s": t_z,
               "launches_per_container_build": per_container,
               "launches_per_lgp_build": per_lgp,
               "rmse": float(np.sqrt(np.mean((mu[0] - func(z)) ** 2))),
               "finite": bool(np.isfinite(mu[0]).all() and np.isfinite(var[0]).all()
                              and (var[0] > 0).all())}
        if not runs:
            # the throughput on N_PRED points
            t0 = time.perf_counter()
            mu_p, var_p = system.predict(zp, m=p["pred_m"])
            t_pred = time.perf_counter() - t0
            run.update(predict_points=N_PRED, predict_s=t_pred,
                       predict_pts_per_s=N_PRED / t_pred,
                       finite_predict=bool(np.isfinite(mu_p[0]).all()
                                           and np.isfinite(var_p[0]).all()))
        runs.append(run)
    counts = cv.launch_counts()
    launches = launch_counts()
    median = float(np.median([r["rmse"] for r in runs]))
    gate = 2.0 * ref["lgp"]["rmse_median"]
    checks = {
        "gp_params_vs_jax": all(np.allclose(np.atleast_1d(trained[k]),
                                            np.atleast_1d(ref["gp"][k]),
                                            rtol=GP_RTOL_PARAMS, atol=0.0)
                                for k in ("scale", "length", "nugget")),
        "gp_K1": trained["launches"]["block_nllik_grad_parts_t"] > 0,
        "launches": all(launches[k] > 0 for k in ("block_nllik_grad_parts_t",
                                                  "block_loglik_multi_t", "cond_weights_t",
                                                  "linked_dense_t")),
        "no_plain_calls": not any(c["plain_calls"] for c in counts.values()),
        "finite": all(r["finite"] for r in runs) and runs[0]["finite_predict"],
        "rmse_median": median <= gate,
    }
    emit({"phase": "linked", "n": p["n"], "m": p["m"], "N": p["lgp_N"],
          "nvidia_smi": nvidia_smi(), "gp": trained, "jax_gp": ref["gp"], "runs": runs,
          "rmse_median": median, "rmse_gate": gate,
          "jax_rmse_by_seed": ref["lgp"]["rmse_by_seed"], "launches": launches,
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"linked phase checks failed: {checks}")
    return launches


def phase_lik_vecchia(dev):
    import torch
    from dgp_tpu_torch import Hetero, combine, dgp, emulator, kernel, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    ref = _data_json("lik_n2000.json")
    p, jax_res = ref["protocol"], ref["jax"]
    X, Y, z, Xh, Yh = lik_data(p)
    zp = np.linspace(-1, 1, N_PRED).reshape(-1, 1)
    l0, l1, l2 = p["length"]

    def fit(seed):
        """The protocol at one training seed: the trained model, its
        emulator (same seed) and the seconds and counts on the way."""
        layers = combine(
            [kernel(length=np.array([l0]), name=p["kernel"], nugget=p["nugget"])],
            [kernel(length=np.array([l]), name=p["kernel"], nugget=p["nugget"],
                    scale_est=True, connect=np.arange(1)) for l in (l1, l2)],
            [Hetero()])
        nb_seed(seed)
        t0 = time.perf_counter()
        m = dgp(X, Y, layers, vecchia=True, m=p["m"], device=dev)
        torch.cuda.synchronize()
        info = {"dgp_construct_s": time.perf_counter() - t0}
        before = launch_counts()
        draws_before = exact_draw_counts()
        t0 = time.perf_counter()
        m.train(N=p["train_N"], disable=True, chunk_size=p["chunk_size"])
        torch.cuda.synchronize()
        info["train_s"] = time.perf_counter() - t0
        info["launches_per_iteration"] = {k: (v - before[k]) / p["train_N"]
                                          for k, v in launch_counts().items()}
        info["exact_draws_in_training"] = {k: v - draws_before[k]
                                           for k, v in exact_draw_counts().items()}
        est = m.estimate()
        nb_seed(seed)
        t0 = time.perf_counter()
        emu = emulator(est, N=p["emulator_N"], device=dev)
        torch.cuda.synchronize()
        info["emulator_build_s"] = time.perf_counter() - t0
        return m, est, emu, info

    # the protocol's own seed: every figure, time and count
    cv.reset_launch_counts()
    m, est, emu, info = fit(p["nb_seed"])
    mu, var = emu.predict(z, m=p["pred_m"])
    t0 = time.perf_counter()
    mu_p, var_p = emu.predict(zp, m=p["pred_m"])
    t_pred = time.perf_counter() - t0
    t0 = time.perf_counter()
    nll, nll_each = emu.nllik(Xh, Yh, m=p["pred_m"])
    t_nll = time.perf_counter() - t0
    launches = launch_counts()
    engine = m.imp._engine()
    sd_h = lik_noise_sd(Xh)
    oracle = float(np.mean(0.5 * np.log(2 * np.pi * sd_h ** 2)
                           + (Yh - func(Xh)) ** 2 / (2 * sd_h ** 2)))
    rmse_mean = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    rmse_var = float(np.sqrt(np.mean((var - lik_noise_sd(z) ** 2) ** 2)))
    # the test nllik over the training seeds that the JAX package was run at
    nll_by_seed = {str(p["nb_seed"]): float(nll)}
    for seed in p["training_seeds"]:
        if str(seed) not in nll_by_seed:
            nll_by_seed[str(seed)] = float(fit(seed)[2].nllik(Xh, Yh, m=p["pred_m"])[0])
    jax_by_seed = jax_res["test_nllik_by_training_seed"]
    nll_median = statistics.median(nll_by_seed.values())
    jax_median = statistics.median(jax_by_seed[str(seed)] for seed in p["training_seeds"])
    gates = {"rmse_mean": LIK_RMSE_FACTOR * jax_res["rmse_mean"],
             "rmse_var": LIK_RMSE_FACTOR * jax_res["rmse_var"],
             "test_nllik_median": jax_median + LIK_NLLIK_SLACK}
    gp_nodes = [nd for layer in m.all_layer for nd in layer if nd.type == "gp"]
    checks = {
        # every node Vecchia: no dense linked layer, so no K5
        "launches": all(launches[k] > 0 for k in ("block_nllik_grad_parts_t",
                                                  "block_loglik_multi_t", "cond_weights_t"))
        and launches["linked_dense_t"] == 0,
        "exact_draws_vecchia": info["exact_draws_in_training"]["vecchia"] > 0
        and engine.exact_draws["dense"] == 0
        and m.all_layer[1][0].imp_NNarray is not None,
        "iterations": m.N == p["train_N"]
        and all(len(nd.para_path) == 1 + m.N for nd in gp_nodes),
        "shapes": mu.shape == (p["n_test"], 1) and mu_p.shape == (N_PRED, 1)
        and nll_each.shape == (p["n_heldout"],),
        "finite": bool(all(np.isfinite(a).all() for a in (mu, var, mu_p, var_p, nll_each))
                       and all(np.isfinite(nd.para_path).all() for nd in gp_nodes)
                       and all(np.isfinite(v) for v in nll_by_seed.values())),
        "variance_positive": bool((var > 0).all() and (var_p > 0).all()),
        "rmse_mean": rmse_mean <= gates["rmse_mean"],
        "rmse_var": rmse_var <= gates["rmse_var"],
        "test_nllik_median": nll_median <= gates["test_nllik_median"],
        "oracle": abs(oracle - jax_res["oracle_nllik"]) < 1e-9,
    }
    emit({"phase": "lik_vecchia", "n": p["n"], "m": p["m"], "dtype": "float64",
          "likelihood": "Hetero", "iterations": m.N, **info,
          "sem_it_per_s": p["train_N"] / info["train_s"], "predict_20000_s": t_pred,
          "predict_pts_per_s": N_PRED / t_pred, "nllik_2000_s": t_nll,
          "launches": launches,
          "exact_draws_per_iteration":
              info["exact_draws_in_training"]["vecchia"] / p["train_N"],
          "rmse_mean": rmse_mean, "rmse_noise_variance": rmse_var,
          "test_nllik": float(nll), "oracle_nllik": oracle,
          "test_nllik_by_training_seed": nll_by_seed, "test_nllik_median": nll_median,
          "jax_test_nllik_by_training_seed": jax_by_seed, "jax_test_nllik_median": jax_median,
          "gates": gates,
          "jax": {k: jax_res[k] for k in ("rmse_mean", "rmse_var", "test_nllik",
                                          "oracle_nllik", "trained")},
          "trained": [{"scale": float(nd.scale[0]), "length": nd.length.tolist(),
                       "nugget": float(nd.nugget[0])} for layer in est for nd in layer
                      if nd.type == "gp"],
          "checks": checks, "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"lik_vecchia phase checks failed: {checks}")
    return launches


def large_data(p):
    """bench.py's `_large_n` draw (tools/make_torch_large_params.py)."""
    rng = np.random.RandomState(p["data_seed"])
    X = rng.rand(p["n"], 1) * 2 - 1
    return X, func(X) + 0.05 * rng.randn(p["n"], 1)


def _timed(fn):
    """(fn(), seconds), the card synchronised on both sides."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def timed_refreshes():
    """Wrap CompiledDGP.refresh_nn so that each call's seconds are
    recorded: (list of seconds, function that restores it)."""
    from dgp_tpu_torch.models.compiled import CompiledDGP
    seconds, refresh = [], CompiledDGP.refresh_nn

    def timed(self, state, gen):
        out, t = _timed(lambda: refresh(self, state, gen))
        seconds.append(t)
        return out

    CompiledDGP.refresh_nn = timed
    return seconds, lambda: setattr(CompiledDGP, "refresh_nn", refresh)


def _recall(approx, exact):
    """Share of the exact sets' entries (-1 padding excluded) that the
    approximate sets hold, row by row (tensors on one device)."""
    hits = total = 0
    for s in range(0, exact.shape[0], 8192):
        e, a = exact[s:s + 8192], approx[s:s + 8192]
        same = (e[:, :, None] == a[:, None, :]) & (e[:, :, None] >= 0)
        hits += int(same.any(dim=2).sum())
        total += int((e >= 0).sum())
    return hits / total


def _search_check(xs, q, m, pred_m):
    """The IVF search of the ordered points xs against the exact search on
    the same device: both timed, the IVF build twice (the arrays must be
    equal), ordered recall, and prediction recall for the queries q."""
    import torch
    from dgp_tpu_torch.vecchia import nn as vnn
    (nn1, _), t_ivf = _timed(lambda: vnn.nn_approx(xs, m))
    (nn2, _), t_ivf2 = _timed(lambda: vnn.nn_approx(xs, m))
    exact, t_exact = _timed(lambda: vnn._nn_ordered_impl(xs, m))
    pa, t_pa = _timed(lambda: vnn._pred_nn_approx(q, xs, pred_m))
    pe, t_pe = _timed(lambda: vnn._pred_nn_impl(q, xs, pred_m))
    return nn1, {"n": xs.shape[0], "d": xs.shape[1], "m": m, "ivf_build_s": [t_ivf, t_ivf2],
                 "builds_equal": bool(torch.equal(nn1, nn2)), "exact_s": t_exact,
                 "recall_ordered": _recall(nn1, exact),
                 "pred_queries": q.shape[0], "pred_m": pred_m, "pred_ivf_s": t_pa,
                 "pred_exact_s": t_pe, "recall_pred": _recall(pa, pe)}


def phase_large_n(dev):
    """The large-n path: the IVF search, a gp and bench.py's n = 1e5 DGP
    protocol (see the module docstring)."""
    import hashlib
    import torch
    from dgp_tpu_torch import dgp, emulator, gp, kernel, nb_seed
    from dgp_tpu_torch.ops import cuda_vecchia as cv

    t_phase = time.perf_counter()
    ref = _data_json("large_n1e5.json")
    p, jax_res = ref["protocol"], ref["jax"]
    rmse_gate = 2.0 * _params_json()["emulator"]["rmse_gate_ref"]
    X, Y = large_data(p)
    n, mv = p["n"], p["vecchia_m"]
    z = np.linspace(-1, 1, p["n_test"]).reshape(-1, 1)
    zp = np.linspace(-1, 1, N_PRED).reshape(-1, 1)
    ordg = np.random.RandomState(p["vecchia_ord_seed"]).permutation(n)
    stride = p["nn_row_stride"]
    jax_rows = np.asarray(jax_res["nn_rows"])

    def rows_vs_jax(NN):
        return {"rows_equal_jax": float(np.mean((NN[::stride] == jax_rows).all(axis=1))),
                "sha256_equal_jax": hashlib.sha256(np.ascontiguousarray(NN, "<i8").tobytes())
                .hexdigest() == jax_res["nn_sha256"]}

    cv.reset_launch_counts()
    parts = {}
    # 1. the search on the gp's scaled, ordered input
    t0 = time.perf_counter()
    xs = torch.as_tensor((X / p["length"])[ordg], device=dev)
    nn1, search = _search_check(xs, torch.as_tensor(zp / p["length"], device=dev), mv,
                                p["pred_m"])
    search.update(rows_vs_jax(nn1.cpu().numpy()))
    parts["search_s"] = time.perf_counter() - t0

    # 2. the gp (Vecchia, m = 25) at n = 1e5
    t0 = time.perf_counter()
    np.random.seed(p["vecchia_ord_seed"])
    k = kernel(length=np.array([p["length"]]), name=p["kernel"], nugget=p["nugget"],
               scale_est=p["scale_est"], nugget_est=p["nugget_est"])
    g, t_build = _timed(lambda: gp(X, Y, k, vecchia=True, m=mv, device=dev))
    before = launch_counts()
    _, t_train = _timed(g.train)
    after_train = launch_counts()
    ll, t_ll = _timed(g.kernel.log_likelihood_func)
    after_ll = launch_counts()
    (mu, var), _ = _timed(lambda: g.predict(z, m=p["pred_m"]))
    rmse_gp = float(np.sqrt(np.mean((mu - func(z)) ** 2)))
    (mu_p, var_p), t_pred = _timed(lambda: g.predict(zp, m=p["pred_m"]))
    gpr = {"nn_method": g.kernel.nn_method, "build_s": t_build, "train_s": t_train,
           "K1_launches_per_train": after_train["block_nllik_grad_parts_t"]
           - before["block_nllik_grad_parts_t"],
           "log_likelihood": ll, "log_likelihood_s": t_ll,
           "K4_launches_per_log_likelihood": after_ll["block_loglik_parts_t"]
           - after_train["block_loglik_parts_t"],
           "rmse": rmse_gp, "rmse_gate": 2.0 * jax_res["rmse"],
           "predict_20000_s": t_pred, "predict_pts_per_s": N_PRED / t_pred,
           "scale": float(g.kernel.scale[0]), "length": g.kernel.length.tolist(),
           "nugget": float(g.kernel.nugget[0]),
           "ordering": bool(np.array_equal(g.kernel.ord, ordg)),
           **rows_vs_jax(g.kernel.NNarray)}
    gp_finite = bool(np.isfinite(ll) and all(np.isfinite(a).all()
                                              for a in (mu, var, mu_p, var_p)))
    parts["gp_s"] = time.perf_counter() - t0

    # 3. bench.py's _large_n and _large_n_predict protocol
    t0 = time.perf_counter()
    refresh_s, restore = timed_refreshes()
    try:
        nb_seed(p["dgp_seed"])
        md, t_dgp = _timed(lambda: dgp(X, Y, _bench_layers(), vecchia=True, m=p["dgp_m"],
                                       check_rep=False, device=dev))
        _, t_warm = _timed(lambda: md.train(N=p["dgp_warm"], disable=True,
                                            chunk_size=p["dgp_chunk"]))
        before = launch_counts()
        _, t_sem = _timed(lambda: md.train(N=p["dgp_timed"], disable=True,
                                           chunk_size=p["dgp_chunk"]))
        per_iter = {k: (v - before[k]) / p["dgp_timed"] for k, v in launch_counts().items()}
    finally:
        restore()
    emu, t_emu = _timed(lambda: emulator(md.estimate(), N=p["dgp_N"], device=dev))
    (mu_d, var_d), _ = _timed(lambda: emu.predict(z, m=p["dgp_pred_m"]))
    rmse_dgp = float(np.sqrt(np.mean((mu_d - func(z)) ** 2)))
    (mu_dp, var_dp), t_dpred = _timed(lambda: emu.predict(zp, m=p["dgp_pred_m"]))
    ivf_used = all(nd["ivf"] is not None for layer in emu._ens.spec for nd in layer)
    for layer_set in emu.all_layer_set:
        for layer in layer_set:
            for nd in layer:
                nd.nn_method = "exact"
    emu._ens = None
    (mu_e, _), t_exact_pred = _timed(lambda: emu.predict(z, m=p["dgp_pred_m"]))
    node = md.all_layer[1][0]
    W = torch.as_tensor((node._X() / node.length)[node.ord], device=dev)
    qW = W[::5] + 1e-3 * torch.randn(W[::5].shape, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev, dtype=W.dtype)
    _, search2 = _search_check(W, qW, p["dgp_m"], p["dgp_pred_m"])
    dgpr = {"nn_method": [nd.nn_method for layer in md.all_layer for nd in layer],
            "construct_s": t_dgp, "warm_s": t_warm, "timed_iterations": p["dgp_timed"],
            "sem_it_per_s": p["dgp_timed"] / t_sem, "launches_per_iteration": per_iter,
            "nn_refresh_s": refresh_s, "emulator_build_s": t_emu, "rmse": rmse_dgp,
            "rmse_gate": rmse_gate, "predict_20000_s": t_dpred,
            "predict_pts_per_s": N_PRED / t_dpred,
            "ivf_vs_exact_mean_abs": float(np.mean(np.abs(mu_d - mu_e))),
            "exact_predict_1000_s": t_exact_pred,
            "trained": [{"scale": float(nd.scale[0]), "length": nd.length.tolist(),
                         "nugget": float(nd.nugget[0])} for layer in md.all_layer
                        for nd in layer]}
    dgp_finite = (all(np.isfinite(nd.para_path).all() for layer in md.all_layer
                      for nd in layer)
                  and all(np.isfinite(a).all() for a in (mu_d, var_d, mu_dp, var_dp, mu_e)))
    parts["dgp_s"] = time.perf_counter() - t0
    launches = launch_counts()
    checks = {
        "recall": min(search["recall_ordered"], search["recall_pred"],
                      search2["recall_ordered"], search2["recall_pred"]) >= LARGE_RECALL,
        "builds_equal": search["builds_equal"] and search2["builds_equal"],
        "rows_vs_jax": search["rows_equal_jax"] >= LARGE_ROWS_EQUAL
        and gpr["rows_equal_jax"] >= LARGE_ROWS_EQUAL,
        "approx": gpr["nn_method"] == "approx" and set(dgpr["nn_method"]) == {"approx"}
        and ivf_used,
        "gp_launches": gpr["K1_launches_per_train"] > 0
        and gpr["K4_launches_per_log_likelihood"] > 0 and gpr["ordering"],
        "gp_params_vs_jax": all(np.allclose(np.atleast_1d(gpr[k]), np.atleast_1d(jax_res[k]),
                                            rtol=GP_RTOL_PARAMS, atol=0.0)
                                for k in ("scale", "length", "nugget")),
        "gp_rmse": rmse_gp <= gpr["rmse_gate"],
        "dgp_launches": all(per_iter[k] > 0 for k in ("block_nllik_grad_parts_t",
                                                      "block_loglik_multi_t",
                                                      "cond_weights_t")),
        "dgp_iterations": md.N == p["dgp_warm"] + p["dgp_timed"],
        "finite": gp_finite and dgp_finite,
        "dgp_rmse": rmse_dgp <= rmse_gate,
        "ivf_vs_exact": dgpr["ivf_vs_exact_mean_abs"] < LARGE_ENS_DIFF,
    }
    emit({"phase": "large_n", "n": n, "dtype": "float64", "parts_s": parts,
          "search": search, "search_layer2": search2, "gp": gpr, "dgp": dgpr,
          "jax": {k: v for k, v in jax_res.items() if k != "nn_rows"},
          "launches": launches, "checks": checks,
          "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"large_n phase checks failed: {checks}")
    return launches


def poisson_data():
    """tools/parity_data.py:55-70: Poisson counts with replicates, n=90
    training rows, 200 test points (seed 99)."""
    rs = np.random.RandomState(99)
    n = 10
    X = np.linspace(0, .3, n)[:, None]
    for _ in range(4):
        X = np.concatenate((X, np.linspace(0, .3, n)[:, None]), axis=0)
        X = np.concatenate((X, np.linspace(0.35, 1, n)[:, None]), axis=0)
    f = lambda x: np.exp(np.exp(-1.5 * np.sin(1 / ((0.7 * 0.8 * (1.5 * x + 0.1)
                                                    + 0.3) ** 2))))
    Y = np.array([rs.poisson(f(x)) for x in X]).reshape(-1, 1)
    z = np.linspace(0, 1., 200)[:, None]
    test_Yz = np.array([rs.poisson(f(x)) for x in z]).reshape(-1, 1)
    return X, Y, z, None, test_Yz


def negbin_data():
    """tools/parity_data.py:73-90: NegBin draws, n=180 training rows (30
    sites x 6 replicates), step mean and smooth dispersion (seed 99)."""
    rs = np.random.RandomState(99)
    n = 30
    X = np.linspace(0, 1, n)[:, None]
    for _ in range(5):
        X = np.concatenate((X, np.linspace(0, 1, n)[:, None]), axis=0)
    f1 = lambda x: 1 / np.exp(2) if x < 0.5 else np.exp(2)
    f2 = lambda x: np.exp(6 * x ** 2 - 3)
    draw = lambda x: rs.negative_binomial(1 / f2(x), 1 / (1 + f1(x) * f2(x)))
    Y = np.array([draw(x) for x in X]).reshape(-1, 1)
    Xt = np.linspace(0, 1., 200)[:, None]
    Yt = np.array([f1(x) for x in Xt]).reshape(-1, 1)
    test_Yt = np.array([draw(x) for x in Xt]).reshape(-1, 1)
    return X, Y, Xt, Yt, test_Yt


def zip_data():
    """tools/parity_data.py:117-137: a synthetic zero-inflated Poisson draw,
    40 sites x 4 replicates (seed 99), scored on a fresh 200-point draw."""
    rs = np.random.RandomState(99)
    n = 40
    X = np.linspace(0, 1, n)[:, None]
    for _ in range(3):
        X = np.concatenate((X, np.linspace(0, 1, n)[:, None]), axis=0)
    f_lam = lambda x: np.exp(1.2 * np.sin(2 * np.pi * x) + 1.0)
    f_pi = lambda x: 1.0 / (1.0 + np.exp(-(2.5 * x - 1.0)))
    Y = np.where(rs.rand(len(X)) < f_pi(X[:, 0]), 0,
                 rs.poisson(f_lam(X[:, 0]))).reshape(-1, 1).astype(float)
    Xt = np.linspace(0, 1, 200)[:, None]
    lam_t, pi_t = f_lam(Xt[:, 0]), f_pi(Xt[:, 0])
    Yt_mean = ((1 - pi_t) * lam_t).reshape(-1, 1)
    test_Yt = np.where(rs.rand(len(Xt)) < pi_t, 0,
                       rs.poisson(lam_t)).reshape(-1, 1).astype(float)
    return X, Y, Xt, Yt_mean, test_Yt


def _lik_row_layers(name):
    """The structures of tools/parity.py:116, 166-172, 195-201."""
    from dgp_tpu_torch import NegBin, Poisson, ZIP, combine, kernel

    def k(length, **kw):
        return kernel(length=np.array([length]), name='matern2.5', **kw)
    if name == "poisson":
        return combine([k(0.5, scale_est=True)], [Poisson()])
    length, lik = (0.02, NegBin()) if name == "negbin" else (0.2, ZIP())
    return combine([k(0.5)], [k(length, scale_est=True, connect=np.arange(1))
                              for _ in range(2)], [lik])


def run_lik_row(task):
    """One parity row on the port at one SEM seed, on the current card:
    its figures, seconds and kernel launches.  ``task`` is (row, nb_seed);
    a worker process of `phase_host_bound` runs it."""
    import torch
    from dgp_tpu_torch import dgp, emulator, nb_seed
    name, seed = task
    torch.set_num_threads(1)
    dev = torch.device("cuda", 0)
    row = LIK_ROWS[name]
    X, Y, Xt, truth, test_Y = {"poisson": poisson_data, "negbin": negbin_data,
                               "zip": zip_data}[name]()
    nb_seed(seed)
    t0 = time.perf_counter()
    m = dgp(X, [Y], _lik_row_layers(name), device=dev)
    t_dgp = time.perf_counter() - t0
    t0 = time.perf_counter()
    m.train(N=row["train"], disable=True)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    emu = emulator(m.estimate(), N=row["N"], device=dev)
    t_emu = time.perf_counter() - t0
    mu, var = emu.predict(Xt)
    nll = float(emu.nllik(Xt, test_Y)[0])
    out = {"row": name, "nb_seed": seed, "n": len(X), "sites": m.n_data,
           "train_N": row["train"], "imputations": row["N"], "dgp_construct_s": t_dgp,
           "train_s": t_train, "sem_it_per_s": row["train"] / t_train,
           "emulator_build_s": t_emu, "test_nllik": nll,
           "finite": bool(np.isfinite(mu).all() and np.isfinite(var).all()
                          and np.isfinite(nll)),
           "launches": launch_counts()}
    if row["rmse"] is not None:
        out["rmse_mean_vs_truth"] = float(np.sqrt(np.mean((mu.flatten()
                                                           - truth.flatten()) ** 2)))
    return out


def phase_host_bound():
    """`dense_dgp` and `lik_rows`: small dense models whose SEM is bound by
    the host, one worker process for `dense_dgp` and one for each run of a
    row, side by side on the one card; each prints its own line."""
    import multiprocessing

    t_phase = time.perf_counter()
    tasks = [(name, seed) for name, row in LIK_ROWS.items() for seed in row["seeds"]]
    with multiprocessing.get_context("spawn").Pool(len(tasks) + 1) as pool:
        dense = pool.apply_async(run_dense_dgp)
        runs = pool.map(run_lik_row, tasks)
        dense = dense.get()
    emit(dense)
    if not all(dense["checks"].values()):
        raise SystemExit(f"dense_dgp phase checks failed: {dense['checks']}")
    rows, launches = [], {k: 0 for k in SOURCES}
    for name, row in LIK_ROWS.items():
        mine = [r for r in runs if r["row"] == name]
        out = {"row": name, "nb_seeds": list(row["seeds"]),
               "finite": all(r["finite"] for r in mine)}
        ok = out["finite"]
        for key, fig in (("nllik", "test_nllik"), ("rmse", "rmse_mean_vs_truth")):
            if row[key] is None:
                continue
            gate = round(sum(row[key]) if key == "nllik" else row[key][0] * row[key][1], 4)
            out[fig] = statistics.median(r[fig] for r in mine)
            out[f"{key}_parity_gate"] = gate
            ok = ok and round(out[fig], 4) <= gate
        out["pass"] = bool(ok)
        rows.append(out)
        for r in mine:
            for k, v in r["launches"].items():
                launches[k] += v
    checks = {**_dense_checks(launches), **{r["row"]: r["pass"] for r in rows}}
    # "seconds": the pool's, dense_dgp's worker included
    emit({"phase": "lik_rows", "rows": rows, "runs": runs, "processes": len(tasks) + 1,
          "launches": launches, "checks": checks,
          "seconds": time.perf_counter() - t_phase})
    if not all(checks.values()):
        raise SystemExit(f"lik_rows phase checks failed: {checks}")
    return {k: v + dense["launches"][k] for k, v in launches.items()}


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import dgp_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    phase_device()
    phase_build()
    results = phase_kernels(dev)
    results["linked_dense_t"] = phase_linked_dense(dev)
    results["vecchia_pred_t"] = phase_vecchia_pred(dev)
    launches = {k: 0 for k in SOURCES}
    for phase in (phase_main, phase_design, phase_train, phase_nodewise, phase_gp, phase_ref, phase_gate,
                  phase_parallel, phase_linked, phase_lik_vecchia, phase_large_n):
        for k, v in phase(dev).items():
            launches[k] += v
    for k, v in phase_host_bound().items():
        launches[k] += v
    emit({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCES[k][0],
         "replaces": SOURCES[k][1], "launches": launches[k],
         "max_abs_err": results[k]["max_abs_err"], "ms": results[k]["ms"],
         "plain_ms": results[k]["plain_ms"], "bound_ms": results[k]["bound_ms"],
         "bound_by": results[k]["bound_by"],
         "library_ms": results[k]["library_ms"]} for k in SOURCES]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
