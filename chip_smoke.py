#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (deeplearning4j_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every kernel from csrc/ with nvcc for sm_90a (one nvcc
   per source, started together; a library is named by a digest of its
   source and the csrc headers it includes) and print the build time, the
   ptxas report and each library's count of tensor-core (HMMA)
   instructions and of local-memory spill instructions (STL, LDL) from
   cuobjdump -sass, or that cuobjdump is absent; a tensor-core kernel (K3f,
   K3k, K3q, K1) with no HMMA fails;
2. kernel parity: each kernel against its plain PyTorch version on the card:
   the forward (K3f) as (o, lse) over T in {8, 65, 100, 512, 1000, 1024,
   2048} (65 and 1000 ragged), Dh in {16, 24, 64, 128} (each head-dim
   bucket), causal and not, f32 and bf16, and on element-offset views at
   T=100; the backward pair (K3k: dK, dV; K3q: dQ) from K3f's o and lse
   over T in {1, 65, 100, 512, 2048}, Dh in {8, 40, 64, 96, 128} (each
   head-dim bucket), causal and not, f32 and bf16; then K3f's time at the
   serving shape (B=1, H=4, T=2048, Dh=128, causal, bf16) and all three at
   the training shape (B=4, H=4, T=2048, Dh=128, causal; f32, the training
   path's type, and bf16), each beside its plain version's time, torch's
   scaled_dot_product_attention (forward for K3f; fwd+bwd minus fwd for the
   K3k+K3q pair: a yardstick the port never calls) and the card's bound
   (CUDA events, median of 30 after warm-up, by device_ms, each kernel's
   time_ms beside it);
3. serving at the flagship's full width (vocab 2048, d_model 512, 4 heads of
   128, 4 experts, d_ff 1024, 2 layers; random weights from a seed):
   DecodeEngine(n_slots=8, max_len=2048, serve_dtype="bf16") answers 10
   greedy requests submitted before run_until_idle(), as the CLI's predict
   does, with prompts across the buckets; the forward kernel's launch count
   over that run must equal n_layers x the admissions whose bucket resolves
   to the kernel. A second engine with attn_impl="flash" on short prompts
   must do the same. The main path's requests run once more under
   torch.profiler for the device busy share and the kernels that take it.
   Prefill logits of one long prompt through the kernel and through dense
   attention must agree within 1e-3 at f32;
3b. the serving fast path on the same flagship (n_slots=8, max_len=2048):
   24 greedy requests of 16 new tokens, each one of 2 shared 1024-token
   system prefixes (64 pages of 16) and its own 16-900-token suffix, driven
   by serve.run_open_loop at half the request rate the plain engine
   sustains in one burst, through four engines: plain, prefix_cache=True,
   speculative=SpeculativeConfig(k=4, draft_layers=1), and all three with
   prefill_chunk=256. At f32 (serve_dtype=None, traced into a temporary
   directory): every request finishes its 16 tokens; every fast-path
   stream equals the plain engine's or leaves it only where the plain
   run's top-2 logits tie within 1e-3 of the largest |logit| (position and
   gap printed); a prompt whose pages cover it is admitted twice and the
   second admission adds nothing to serve_prefill_dispatches_total; the
   prefix cache's invariants hold; the trace holds one serve.request tree
   per request with its four children and each prefill span's mode equal
   to the request's record; the forward kernel launches exactly
   n_layers x the classic prefills plus draft_layers x the draft
   admissions whose bucket resolves to it, never zero times, and that
   count and the admission modes are what the traffic fixes (plain
   n_layers x requests; prefix cache n_layers x the 2 prefixes' cold
   misses; speculative plain's plus draft_layers x requests; composed
   draft_layers x requests). At bf16 each engine, warmed by a burst of
   other prompts, runs 192 requests of the same mix on the same kind of
   schedule with the same checks but for the streams (their matching
   share is logged): tokens/s,
   first-token, latency and inter-token p50/p99, the prefix hit rate and
   pages held, the accept rate and each verify step's ms against its draft
   steps' ms (k+1 draft decodes with k reads to the host), and the
   composed engine once more on new prompts under torch.profiler for the
   device busy share; then a classic prefill and chunk steps of widths
   64, 512 and 1024 alone, at f32 and bf16: host ms to the fenced token
   and, profiled, device ms and kernel launches;
4. training at the same width: make_single_device_train_step(4,
   donate=True) with the auto core takes 2 warm-up and 10 timed SGD steps
   on one (B=4, T=2048) batch; every loss is finite, the last below the
   first, and each of K3f, K3k and K3q launches exactly n_layers x 10
   times. One step's loss and grads through the kernels agree with dense
   attention's (f32), with non-zero grads for wq, wk and wv, and both
   routes' grads are held against a float64 dense step on the same inputs,
   per leaf (logged); two steps of the Adam step with guard= and
   with_metrics= run through the kernels; the timed steps run once more
   under torch.profiler for the busy share; one step at d_model / n_heads
   = 256 (2 heads), T=1024, with the auto core runs dense attention (the
   kernels take Dh up to 128): finite, no flash launch;
5. the MNIST MLP (models/zoo.mnist_mlp at the bench's full width:
   784-500-300-10, relu, softmax/MCXENT, SGD lr 0.1 momentum 0.9, batch 512,
   data from synthetic_mnist): the fused-dense kernel K1 against its plain
   version on the card over 7 shapes (both MLP layers, ragged edges, 2-byte
   bf16 pitches) and both MLP layers from element-offset views x 4
   activations x f32/bf16, then its time at both hidden layers' shapes (f32
   and bf16) beside its plain version, torch.relu(torch.addmm(b, x, w))
   (two calls, a yardstick the port never calls) and the card's bound,
   timed with the card held busy while the host enqueues each call
   (device_ms);
   MultiLayerNetwork.fit_epochs over a ListDataSetIterator, 2 warm-up and
   MLP_STEPS timed steps (K1 launches exactly 2 x steps; the score on the
   first timed batch finite and lower after the run);
   make_train_epoch(conf, 200, donate=True) at f32 and under BF16_COMPUTE
   on a (200, 512, 784) chunk as bench.measure builds it (400 launches a
   chunk), a profiled chunk for the busy share;
   predict on 512 held-out examples (2 launches, accuracy above 0.9); one
   step's loss and grads through K1 against the plain dense route (f32);
6. the char-LSTM (models/zoo.char_lstm at the bench's lstm_wide width:
   vocab and hidden 512, batch 64, sequence 64, one-hot random tokens as
   bench.py makes them): the LSTM-cell kernel K2 against its plain version
   on the card over 6 shapes x f32/bf16/mixed inputs and both bench
   shapes from element-offset views, and the cell's backward K2b against
   its own over the same 6 shapes' 24 cases with random dc_new and dh and
   12 more as the last timestep's grads arrive (dc_new None, dh a row view
   of stride 3H); the launch floor (an empty kernel launched through K2's
   library on K2's grid, and K2 and K2b at 1x1); then K2's and K2b's time
   at both bench shapes (64x512, 256x128) beside their plain versions,
   ATen's _thnn_fused_lstm_cell and
   _thnn_fused_lstm_cell_backward_impl (yardsticks the port never calls),
   the floor and the bound; MultiLayerNetwork.fit_epochs, 2 warm-up and
   LSTM_STEPS timed steps at lr 0.01 (K2 and K2b each launch exactly 64 x
   steps; the score on the first timed batch finite and lower after the
   run); make_train_epoch(conf, 8, donate=True) chunks at f32, under
   BF16_COMPUTE, with set_lstm_gates(False) (the bench's _nokernels twin:
   neither kernel launches) and profiled with the kernels on and off
   (busy share, device operations a step and the most frequent by name,
   K2's and K2b's shares of device time); predict on a held-out batch (64
   K2 launches, no K2b, (64, 64) tokens); one step's loss and grads
   through K2 and K2b against the plain cell (f32);
7. the attention char-LM (models/zoo.char_attention_lm at the bench's
   attn_long width: vocab 128, d_model 512, 4 heads, batch 4, T=2048):
   fit_epochs, 2 warm-up and ATTN_STEPS timed steps with the auto core
   (K3f, K3k and K3q each launch once a step), output on one batch (one
   K3f launch), one step's loss and grads through the kernels against
   dense attention (f32) with non-zero grads for wq, wk and wv;
8. the CLI (deeplearning4j_tpu_torch.cli.driver), the user's entry point:
   the trained flagship params of phase 4 saved by Checkpointer (meta from
   lm_checkpoint_meta) and restored onto the card from the manifest alone,
   every leaf torch.equal, and the same for a bf16 copy (save and restore
   ms and bytes logged); ``predict --model <ckpt_dir> --max-len 2048
   --slots 8 --max-new-tokens 16 --serve-dtype bf16`` on prompts of
   PROMPT_LENS, in process with the launches counted from 0 (K3f exactly
   n_layers x the admissions whose bucket resolves to it), its rows equal
   to a direct DecodeEngine's on the same params and knobs, then once more
   as ``python -m deeplearning4j_tpu_torch.cli.driver`` in a subprocess
   (exit 0, the same file); ``train`` (2 epochs, batch 512), ``test`` and
   ``predict`` of zoo.mnist_mlp's conf JSON on CSVs of synthetic_mnist
   (4096 rows to train on, 1024 held out), each with the launches counted
   from 0 (K1 exactly 2 x the train steps and 2 x the batches of test and
   of predict), test's accuracy above 0.9, predict's classes equal to
   net.predict of a net loaded from the same params.npz; the CLI's
   tokens/s, ms per MLP step and CSV read time logged;
9. slice 5 (TF32 off unless a run says otherwise): K1 against its plain
   version at LeNet's dense shapes (512x256 @ 256x120, 512x120 @ 120x84)
   and conv_wide's (64x3200 @ 3200x256), every activation, f32 and bf16,
   then its time there beside its plain version, addmm+relu and the
   bound; LeNet (models/zoo.lenet, BASELINE #2, batch 512 of
   synthetic_mnist): MultiLayerNetwork.fit_epochs, 2 warm-up and
   LENET_STEPS timed steps at lr 0.02 (LENET_FIT_LR: the zoo's 0.05 sends
   about 1 init in 12 to chance; K1 exactly 2 x steps: layers 4 and 5;
   the score on the first timed batch falls), predict on 512 held-out
   examples (2 launches, accuracy above 0.9), the held-out accuracy of 12
   inits after as many steps at lr 0.05 and 0.02 (logged), 200-step
   make_train_epoch chunks at f32 and bf16 (400 launches each) and a
   profiled f32 chunk (busy share, device operations a step, the
   convolution kernels' share of device time by name), one step's loss
   and grads through K1 against the plain dense route (f32, the MLP's
   limits); LeNet's and conv_wide's two convolutions each through both
   conv2d routes (cuDNN, its weight gradient one product over the
   patches; unfold + one product): device ms forward and forward +
   backward at f32 and bf16, each route's f32 output and grads and
   cuDNN's own backward's against a float64 reference (logged), the
   routes within CONV_ROUTE_TOL of each other at f32, and LeNet's
   convolutions' share of a step's device time; conv_wide
   (models/zoo.conv_wide, batch 64 of (32, 32, 32) normal inputs) in
   32-step chunks at f32, bf16, f32 under cuDNN's TF32 default, and
   profiled at f32 and bf16 (K1 exactly once a step); the stacked
   denoising autoencoder (models/zoo.stacked_denoising_autoencoder at its
   defaults, 784-500-250-10, BASELINE #3) driven by fit on 4096
   synthetic_mnist rows at batch 512: pretrain, finetune, backprop, each
   with its listener calls counted, its wall time and its score falling,
   K1 exactly 0; a fresh head finetuned by CONJUGATE_GRADIENT, LBFGS and
   HESSIAN_FREE on the card over the fitted stack's activations (score
   falls, params finite); LeNet's fit_epochs with
   CheckpointIterationListener saving every 50 iterations, and
   restore_net of step 50 equal (torch.equal, on the card) to the
   params, updater state and key the live net held at that iteration;
10. slice 6 (no kernel of the port runs on its path but K1 in the last
   step): the native host library's g++ build time (built beside the
   nvcc builds of phase 1); Word2Vec's build_vocab on bench.py's
   word2vec_large corpus (20,000 sentences of 100 words, zipf over
   50,000 words, numpy seed 0) through the native path (its
   corpus_index call counted) and the Python path, both wall times, equal
   vocab and index arrays; at word2vec_large's width (D 256, window 5,
   negative 5 shared in groups, sample 1e-3, batch 65,536) a warm fit,
   a fit timed to block_until_ready (words/s: corpus words over wall;
   last_fit_timings) and a profiled fit (busy share, device operations a
   step, the top ones); the same at bench.py's toy word2vec scale (V
   5,000, D 100, 200k words, batch 8,192) with shared and per-pair
   negatives and with hierarchical softmax; one SGNS (shared, per-pair)
   and one HS epoch of the device functions on the card against the CPU
   from the same draws (W2V_CARD_TOL); the tests' learning checks of
   Word2Vec, GloVe and ParagraphVectors on the card; the toy model's
   vectors through the text and the binary serializer and back; and
   NativeCSVDataSetIterator over a CSV of synthetic_mnist feeding two
   epochs of MultiLayerNetwork.fit_epochs of the MNIST MLP (native, K1
   exactly 2 launches a step, the score falling); each number beside the
   card's name and power limit;
11. slice 7 (no kernel on the RNTN's path; K1 on the trainer's one
   rank): the RNTN at Socher's width (num_hidden 25, 5 classes) on
   8,544 trees (SST's training size) that TreeVectorizer builds from
   seed-drawn sentences of SST-like length: a 1-iteration warm-up fit,
   then a 3-iteration fit (trees/s, ms a bucket step, the loss falling),
   one profiled step of the bucket with the most merges (device
   operations a merge, busy share); the same fit on 512 trees of 8-40
   words, and every bucket step of its first iteration
   against the same step on the CPU from the card's state (RNTN_STEP_TOL,
   RNTN_LOSS_TOL); then ParameterAveragingTrainer in a real one-rank NCCL
   group (multihost.initialize on a free localhost port, destroyed in a
   finally) on the MNIST MLP at batch 512 of synthetic_mnist: fit_epochs,
   the trainer in both averaging modes, its sync step called directly
   (no host read a step) with and without the all-reduce
   (ablate_collectives), and with Adam replicated and ZeRO-sharded,
   TRAINER_STEPS timed steps each after
   TRAINER_WARMUP; K1 exactly 2 launches a step, exactly one all-reduce a
   sync step (and one all-gather sharded), both modes within TRAINER_TOL
   of fit_epochs from the same params, Adam's modes within ZERO_TOL;
   samples/s of each beside fit_epochs';
12. slice 8, in a one-rank NCCL group (world size 1: one card, no
   multi-card figure): (a) make_composed_train_step on data_parallel_mesh
   at the flagship's full width and training shape (B=4, T=2048, f32)
   with SGD, Adam replicated and Adam ZeRO-sharded, DP_STEPS steps each
   against make_single_device_train_step from the same params and batch
   (params of each leaf's max and losses within DP_TOL), K3f, K3k and K3q
   exactly n_layers x steps, exactly 2 all-reduces a step (and 1
   all-gather sharded), ms a step and tokens/s of both; (b) Word2Vec's
   sharded SGNS step (shared and per-pair negatives) and HS step at
   word2vec_large's width (V 50,000, D 256, 65,536 pairs) on the card
   against the same step on the CPU from the same state and draws
   (W2V_CARD_TOL), and a Word2Vec(mesh=...) fit of the word2vec_large
   corpus timed beside phase 10's device-epoch fit (the mesh step
   all-reduces two dense V x D tables); (c) LocalDistributedRunner on the
   MNIST MLP (RUNNER_JOBS batch-512 jobs, RUNNER_WORKERS threads,
   MultiLayerNetworkWorkPerformer on the card): the sync run from one
   draw of params put in through update(), each round's average against
   the CPU's round from the same incoming params (RUNNER_TOL of each
   leaf's max, or for a leaf a ReLU kink flip moves, KINK_TOL, a few
   examples' share, of the round's update's max), K1 exactly
   2 x iterations x jobs, samples/s beside fit_epochs'; a HogWild run that
   finishes with its score falling; the trained net through
   save_checkpoint / load_checkpoint and save_checkpoint_to_store over
   mem://, torch.equal; (d) Word2VecWorkPerformer jobs on the card against
   the CPU's from the same draws (W2V_CARD_TOL);
13. slice 4c and item 19b, over loopback TCP: (a) the serving fleet at
   the flagship's width: a StateTrackerServer on 127.0.0.1:0, two
   FleetReplicas in this process built by FleetReplica.from_live_params
   from its address (two TCP clients each; N_SLOTS x MAX_LEN engines
   over the same params on the card) and a FleetRouter over its own
   StateTrackerClient, driven by serve.run_open_loop(sessions=) at 1.5x
   the request rate one warmed bf16 engine sustains in a burst: at f32
   24 greedy requests of 16 new tokens (prompts of PROMPT_LENS in turn,
   sessions s0, s1 and unpinned in turn): every stream equals one
   engine's (one request at a time) or leaves it only at a top-2 tie
   (phase 3b's rule), each session rode one replica, nothing was
   requeued, and K3f launched exactly n_layers x the admissions, summed
   over both replicas, whose bucket resolves to it; at bf16, warmed, 96
   requests through the fleet and through one engine on the same
   schedule (tokens/s, first-token and latency p50/p99, the same launch
   check) and the fleet once more under torch.profiler (busy share);
   (b) chaos at f32: one replica die()s while mid-stream on an
   unfinished request; every request finishes by the same stream rule,
   the victim alone is buried (its fleet_replica_heartbeat_unix gauge
   -1.0), at least one request requeued, and the cold_start callback's
   replacement (FleetReplica.from_live_params from the card's params)
   turns alive; (c) ``python -m deeplearning4j_tpu_torch.cli.driver
   fleet --replica --synthetic <flagship> --seed 0 --slots 8 --max-len
   2048 --serve-dtype none`` as a process (stdout drained by a thread):
   it prints FLEET_REPLICA_READY, a router's 4 greedy requests equal an
   in-process engine's over the same seeded synthetic params, and after
   finish() it exits 0 (killed in a finally); (d) DistributedMaster with
   two in-process DistributedWorker threads over TCP, each a
   MultiLayerNetworkWorkPerformer on the card, over 8 batch-512
   synthetic_mnist jobs of the MNIST MLP: K1 exactly 2 x iterations x
   jobs, the score falling, each aggregation against the CPU's average
   of the same jobs from the same incoming params (phase 12's
   RUNNER_TOL or its ReLU-kink rule), samples/s beside phase 12's
   LocalDistributedRunner; then 4 jobs through one worker process
   (``python -m deeplearning4j_tpu_torch.scaleout.distributed_runner
   --performer chip_smoke:dist_performer --device cuda``) that finishes
   them and exits 0;
14. item 20a (composed parallelism), the ring first, then in a one-rank
   NCCL group (world size 1: the ring, the all-to-alls and the stage hops
   are one rank's): (a) ring_attention_in_process, the ring's per-rank
   body over 4 sequence shards of 512 held in one process, "blockwise"
   forced, causal, at the training shape (B=4, H=4, T=2048, Dh=128) in
   f32 and bf16: output and the grads of sum(o²) against the unsharded
   kernel route at phase 2's tolerances, K3f, K3k and K3q each exactly
   P(P+1)/2 = 10 launches a call, prefetch on and off bit-identical, the
   ring's device ms beside the unsharded pass's; an unaligned
   blockwise_block_partials offset raises on the card; (b)
   make_composed_train_step on a ("data", "sp", "expert") mesh of
   (1, 1, 1) at the flagship's full width and training shape: 3 SGD and
   3 Adam steps at ample capacity against make_single_device_train_step
   from the same state (in float64 with dense attention params and
   losses within 1e-10; at f32 through the kernels each loss and each
   leaf's params no farther from the float64 run than the single-device
   step's, within a factor of 2), 3 steps with metrics at
   capacity 1024 (moe_dropped_frac equal
   to the host's expected_dropped over the routes from the same
   activations, layer 0's moe_apply equal to moe_reference within 1e-5,
   the loss finite and falling), K3f, K3k, K3q exactly n_layers x steps,
   the collectives exactly as derived, ms a step and tokens/s beside
   phases 4 and 12; (c) the flagship through make_pp_stages(n_stages=1)
   and make_pp_loss on a ("data", "pipe") mesh of (1, 1), 4 microbatches
   of one 2048-token sequence, 2 SGD steps strict and overlap=True
   (bit-identical; losses and params within 1e-5 of each leaf's max of the
   same steps on the CPU, computed first, or no farther from the same
   steps in float64 than the CPU's, within a factor of 2; K3f, K3k, K3q
   exactly n_layers x microbatches a step), and pipeline_from_conf on a 1024→1024 tanh
   dense layer, 4 microbatches of 512 rows (K1 once a microbatch, the
   output the layer's dense.forward);
15. items 20b and 20c (tensor parallelism, checkpoints over a mesh, the
   guard's host half; ``slice20bc``);
16. item 20d (elastic parameter averaging; ``slice20d``), at the width of
   JAX's largest elastic stage (d_in 64, d_hidden 256, batch 512, lr
   0.05, sync_every 48): (a) from one init and one batch stream,
   run_steps' 48 steps on the card against the CPU in three variants
   (SGD, guard=True, Adam): params within 1e-5 of each leaf's max, losses
   1e-5 relative; a nan_at_step batch skipped on the card with params
   (and Adam's moments) bitwise unchanged; local steps/s on the card; (b)
   an ElasticMaster in this process and two worker processes
   (``--device cuda``) sharing the card, the victim crashing mid-round 0:
   3 rounds on the survivor equal simulate_elastic on the card within
   1e-6, workers_failed 1, exits 0 and 23; seconds a round, the
   survivor's local steps/s, kill to burial; (c) a second cluster of
   three workers, one poisoned by nan_at_step: quarantined
   (workers_quarantined 1), the master's watchtower fires
   worker_divergence, visible through ClusterAggregator.collect_alerts()
   over TCP, the survivors finish (the final params equal
   simulate_elastic without the poisoned rounds within 1e-6), an
   AsyncCheckpointer saves every version, and a fresh master's resume()
   restores the last bit for bit; quarantine to firing;
17. output: the card's name and power limit from nvidia-smi, one JSON line
   listing each kernel (K3f at the serving shape; K3f, K3k, K3q at the
   training shape in f32 and bf16 with their launches over the timed f32
   training run; K1 at both MLP layer shapes in f32 and bf16 with its
   launches over the timed fit_epochs run, and at LeNet's and conv_wide's
   dense shapes with LeNet's fit_epochs launches and conv_wide's f32
   chunk's; K2 and K2b at both bench shapes
   in f32 with their launches over the timed char-LSTM fit_epochs run and
   the launch floor beside them; K3f's and K1's rows also carry
   ``cli_launches``, their counts over phase 8's CLI runs, and K3f's
   ``fastpath_launches``, its count over each bf16 engine's run of phase
   3b, and K1's ``trainer_launches``, its counts over phase 11's timed
   trainer runs, and ``runner_launches``, its count over phase 12's sync
   runner, and ``distributed_launches``, its count over phase 13's
   in-process DistributedMaster run; K3f's serving row ``fleet_launches``,
   its counts over phase 13's f32 and timed bf16 fleet runs; K3f's, K3k's
   and K3q's training rows ``dp_launches``, their counts over phase 12's
   data-parallel runs, ``ring_launches``, their count over one call of
   phase 14's ring at the row's type, ``composed_launches`` and
   ``pp_launches``, their counts over phase 14's composed and staged
   runs; K1's rows ``pp_launches``, its count over phase 14's
   pipeline_from_conf run), and as the
   last line {"ok": true, "device": {"platform": "gpu", "kind": ...,
   "count": ...}}. An f32 row's bound is that of f32-accurate products: the least
   of the CUDA cores' 67 TFLOP/s and three TF32 products at 495 (the
   kernels' 3xTF32 split), named in bound_by, with the CUDA cores' bound
   kept beside it.

Parity phases run with TF32 off (torch.backends.cuda.matmul.allow_tf32 and
torch.backends.cudnn.allow_tf32 False), so f32 products are full f32.
Without CUDA, or outside a checkout of the repository, the script fails
before printing any result. The last log line before the output gives the
whole script's time.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit); f32 is the
# CUDA cores' rate, outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# the peak of an f32 row whose work is products: the least time the card
# has for f32-accurate products is min(FLOP on the CUDA cores, 3 FLOP of
# TF32 through the 3xTF32 split), which K1 and K3f take
F32_PRODUCTS = "f32 products"
DEVICE = "cuda"
# the checkout this script runs from: phase 13's processes start there
REPO = os.path.dirname(os.path.abspath(__file__))

# the flagship LM's serving width (bench.py's composed-flagship dims)
VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF, N_LAYERS = 2048, 512, 4, 4, 1024, 2
N_SLOTS, MAX_LEN, MAX_NEW = 8, 2048, 16
PROMPT_LENS = (5, 17, 40, 90, 200, 420, 700, 1100, 1500, 2000)
FLASH_PROMPT_LENS = (5, 40, 200)
PARITY_LEN = 1500

TOL = {"float32": {"o": 2e-5, "lse": 2e-5},
       "bfloat16": {"o": 2e-2, "lse": 1e-3}}
# backward kernels: max abs error over the reference's max abs value. Both
# sides compute in f32 from the same inputs, in other summation orders (f32:
# ~1e-6 expected); bf16 outputs round once to bf16 (2^-8 relative)
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}

# the flagship's single-chip training shape (bench.py:101-102, 583-665)
TRAIN_B, TRAIN_T, TRAIN_STEPS = 4, 2048, 10
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                 "flash_attention_bwd_dq")
# kernel vs dense training step at f32: loss absolute, grads as max abs error
# over the leaf's max abs value. Both sides are full f32 summed in other
# orders, but at full width some of the 67M ReLU units of the expert FFNs
# sit within f32 noise of their kink and switch between the two runs; each
# switch moves one token's share (1/8192) of every grad it feeds, and more
# of one expert column: measured up to 2.1e-3 on experts.w1, ~1e-4 on the
# other block leaves, 1e-7 on the decoder's
LOSS_TOL, GRAD_TOL = 1e-4, 1e-2
ADAM_LR = 1e-3
OPT_METRICS = {"loss", "task_loss", "aux_loss", "router_load", "grad_norm",
               "param_norm", "update_ratio", "moment_norm_m",
               "moment_norm_v", "nonfinite", "clipped", "guard_grad_norm"}

# the MNIST MLP at the bench's width (bench.py:53-59, models/zoo.mnist_mlp)
MLP_H1, MLP_H2, MLP_BATCH = 500, 300, 512
MLP_WARMUP, MLP_STEPS, EPOCH_STEPS = 2, 50, 200
HELD_OUT = 512
# K1 parity: (M, K, N) with both MLP layers (bf16 rows of 500 and 300
# elements are 8-byte aligned only), a wider K, the head's shape, ragged
# edges on every side (257 x 100 x 129: K not a multiple of the 32-deep
# chunk, M and N past a tile) and 2-byte bf16 pitches (5x7x3, 1x1x1); then
# both MLP layers from element-offset views. Error is max abs error over
# the reference's max abs value: f32 sums in another order (~1e-6
# expected), bf16 rounds once (2^-8)
DENSE_SHAPES = ((512, 784, 500), (512, 500, 300), (512, 1024, 512),
                (100, 300, 10), (257, 100, 129), (5, 7, 3), (1, 1, 1))
DENSE_OFFSET_SHAPES = ((512, 784, 500), (512, 500, 300))
DENSE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# K1 vs the plain dense route, one MLP step at f32: loss absolute; grads as
# max abs error over the leaf's max. Looser than f32 rounding: at batch 512
# a hidden unit within f32 noise of 0 can switch between the two runs (the
# ReLU-kink finding of the LM training grads)
MLP_LOSS_TOL, MLP_GRAD_TOL = 1e-5, 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# cycles of torch.cuda._sleep ahead of each timed call in device_ms: about
# 1 ms at the H100's clocks, longer than the host takes to enqueue the call
SLEEP_CYCLES = 2_000_000


def device_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` (CUDA events) with the
    host's launch cost kept out: the card sleeps while the host enqueues
    the start event and the call, so the interval holds only the call's
    kernels. ``time_ms``'s interval also holds the host's enqueue time when
    the card idles meanwhile, which matters for calls of tens of us."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------------- phase 1 ----

# the kernels built on csrc/hopper_mma.cuh's mma.sync: their SASS must hold
# tensor-core instructions
TENSOR_CORE_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dkv",
                       "flash_attention_bwd_dq", "fused_dense")


def build_kernels() -> None:
    from deeplearning4j_tpu_torch.native import lib as nlib
    from deeplearning4j_tpu_torch.ops import _kernels

    def native_build():
        t = time.perf_counter()
        fresh = not nlib.library_path().exists()
        path = nlib.build()
        return {"path": path.name, "built": fresh,
                "build_s": time.perf_counter() - t}

    names = sorted(_kernels.LAUNCHES)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
        native = pool.submit(native_build)  # g++ beside the nvcc builds
        for name, path in zip(names, pool.map(_kernels.build, names)):
            log(f"[build] {name}: {path.name}")
            for line in _kernels.build_logs.get(name, "").splitlines():
                if any(w in line for w in ("registers", "spill", "error",
                                           "warning")):
                    log(f"[build]   {line.strip()}")
        NATIVE_BUILD.update(native.result())
    log(f"[build] {len(names)} kernel(s) built in "
        f"{time.perf_counter() - t0:.2f} s; the native library "
        f"{NATIVE_BUILD['path']} by g++ in {NATIVE_BUILD['build_s']:.2f} s"
        f"{'' if NATIVE_BUILD['built'] else ' (found built)'}")
    cuobjdump = _cuda_tool("cuobjdump")
    if cuobjdump is None:
        log("[build] cuobjdump not found: tensor-core instruction counts "
            "not taken")
        return
    for name in names:
        sass = subprocess.run([cuobjdump, "-sass",
                               str(_kernels._library_path(name))],
                              capture_output=True, text=True).stdout
        counts = {op: len(re.findall(rf"\b{op}\b", sass))
                  for op in ("HMMA", "STL", "LDL")}
        log(f"[build] {name}: {counts['HMMA']} tensor-core (HMMA) "
            f"instructions in its SASS; local-memory spills: "
            f"{counts['STL']} STL, {counts['LDL']} LDL")
        if name in TENSOR_CORE_KERNELS and counts["HMMA"] == 0:
            raise AssertionError(f"{name} has no tensor-core instruction")


def _cuda_tool(name: str):
    """The CUDA toolkit's ``name`` (on PATH or under CUDA_HOME), or None."""
    import os
    import shutil

    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which(name)
    if found or not CUDA_HOME:
        return found
    path = os.path.join(CUDA_HOME, "bin", name)
    return path if os.path.exists(path) else None


# ------------------------------------------------------------- phase 2 ----

def _qkv(shape, dtype, seed, offset=0):
    """Three random (B, H, T, Dh) tensors; with ``offset`` each is a view
    ``offset`` elements into its storage, so its base is only element-
    aligned (the kernels then stage with narrower copies)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    n = int(np.prod(shape))
    return [torch.randn(n + offset, generator=gen, device=DEVICE).to(dtype)[
        offset:].view(shape) for _ in range(3)]


# K3f parity: T across the 64-row tiles' edges (65 and 1000 are ragged),
# Dh in each head-dim bucket (16, 24: 32; 64; 128), then element-offset
# views at T=100
FLASH_TS = (8, 65, 100, 512, 1000, 1024, 2048)
FLASH_DHS = (16, 24, 64, 128)


def flash_parity() -> None:
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    cases = [(t, dh, 0) for t in FLASH_TS for dh in FLASH_DHS]
    cases += [(100, dh, 1) for dh in FLASH_DHS]
    n = 0
    for t, dh, offset in cases:
        for causal in (True, False):
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = _qkv((2, 2, t, dh), dtype, seed=t + dh,
                               offset=offset)
                o, lse = fa.flash_attention_fwd(q, k, v, causal)
                ro, rlse = fa.flash_attention_reference(q, k, v, causal)
                torch.cuda.synchronize()
                tol = TOL[str(dtype).split(".")[1]]
                eo = (o.float() - ro.float()).abs().max().item()
                el = (lse - rlse).abs().max().item()
                ok = (o.dtype == dtype and lse.dtype == torch.float32
                      and eo <= tol["o"] and el <= tol["lse"]
                      and torch.isfinite(o.float()).all().item())
                log(f"[parity] flash T={t} Dh={dh} causal={causal} {dtype}"
                    f"{f' offset {offset}' if offset else ''}: o err "
                    f"{eo:.3g} lse err {el:.3g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"flash kernel disagrees with its plain version at "
                        f"T={t} Dh={dh} causal={causal} {dtype} offset "
                        f"{offset}: o {eo} (tol {tol['o']}), lse {el} "
                        f"(tol {tol['lse']})")
                n += 1
    log(f"[parity] flash_attention_fwd: {n} cases agree")


def flash_measure() -> dict:
    """The kernel at the serving shape: its device time (``device_ms``),
    beside it with the host's launch in the interval (``time_ms``), the
    plain version, the library call (SDPA, ``device_ms``) and the bound.
    Inputs stay resident in the 50 MB L2 between calls, as q/k/v do when
    prefill's projections have just written them."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, h, t, dh = 1, N_HEADS, MAX_LEN, D_MODEL // N_HEADS
    q, k, v = _qkv((b, h, t, dh), torch.bfloat16, seed=7)
    o, _ = fa.flash_attention_fwd(q, k, v, True)
    ro, _ = fa.flash_attention_reference(q, k, v, True)
    err = (o.float() - ro.float()).abs().max().item()
    kernel_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    host_ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
    plain_ms = device_ms(lambda: fa.flash_attention_reference(q, k, v, True),
                         reps=20)
    library_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), reps=20)
    flops = 4.0 * b * h * t * t * dh / 2          # causal half of QK^T + PV
    nbytes = 4 * b * h * t * dh * 2 + b * h * t * 4  # q,k,v read, o written
    #                                                 (bf16), lse (f32)
    entry = _kernel_entry(
        "flash_attention_fwd", "deeplearning4j_tpu/ops/flash_attention.py:405",
        kernel_ms, plain_ms, flops, nbytes, PEAK_BF16_FLOPS, err, library_ms,
        f"B={b} H={h} T={t} Dh={dh} causal bfloat16 (serving)",
        ms_with_launch=host_ms)
    log(f"[measure] flash_attention_fwd {entry['shape']}: kernel "
        f"{kernel_ms:.4f} ms ({host_ms:.4f} ms with the host's launch in the "
        f"interval), plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms; "
        f"bound {entry['bound_ms'] * 1e3:.2f} us ({entry['bound_by']}: "
        f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.2f} MB); kernel at "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s; max abs err {err:.3g}")
    # B*H = 4 gives 128 blocks of 64 q rows; if one block's walk over the
    # keys bounds the time, it stays flat with one head and without the mask
    for heads, causal in ((1, True), (h, False)):
        q, k, v = _qkv((b, heads, t, dh), torch.bfloat16, seed=8)
        ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, causal))
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal), reps=20)
        log(f"[measure] flash_attention_fwd B={b} H={heads} T={t} Dh={dh} "
            f"{'causal' if causal else 'not causal'} bfloat16: kernel "
            f"{ms:.4f} ms, sdpa {lib:.4f} ms")
    return entry


# K3k/K3q parity: T from one row through ragged edges (65, 100) to the
# training length; Dh in every head-dim bucket (8: 32; 40, 64: 64; 96, 128:
# 128), columns past dh zero-filled in all but 64 and 128
BWD_TS = (1, 65, 100, 512, 2048)
BWD_DHS = (8, 40, 64, 96, 128)


def bwd_parity() -> None:
    """K3k and K3q against ``flash_attention_bwd_reference`` on the card,
    with o and lse from K3f. Error: max abs error over the reference's max
    abs value, per output. At T=1 a softmax over one key has no gradient
    in its score, so dq = dk = 0 and both sides hold only rounding noise
    (dP against delta): there the two are held to dv's max instead."""
    import torch

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    n = 0
    for t in BWD_TS:
        for dh in BWD_DHS:
            for causal in (True, False):
                for dtype in (torch.float32, torch.bfloat16):
                    q, k, v = _qkv((2, 2, t, dh), dtype, seed=3 * t + dh)
                    do = _qkv((2, 2, t, dh), dtype, seed=7 * t + dh)[0]
                    o, lse = fa.flash_attention_fwd(q, k, v, causal)
                    delta = fa.attention_delta(o, do)
                    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do,
                                                        delta, causal)
                    dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta,
                                                   causal)
                    want = fa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                            do, causal)
                    sync()
                    tol = BWD_TOL[str(dtype).split(".")[1]]
                    scale = want[2] if t == 1 else None
                    errs = [_rel_err(g, w, scale) for g, w in
                            zip((dq, dk, dv), want)]
                    ok = (all(e <= tol for e in errs)
                          and all(g.dtype == dtype
                                  and torch.isfinite(g.float()).all().item()
                                  for g in (dq, dk, dv)))
                    log(f"[parity] bwd T={t} Dh={dh} causal={causal} "
                        f"{dtype}: rel err dq {errs[0]:.3g} dk {errs[1]:.3g} "
                        f"dv {errs[2]:.3g} {'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise AssertionError(
                            f"backward kernels disagree with their plain "
                            f"version at T={t} Dh={dh} causal={causal} "
                            f"{dtype}: dq/dk/dv {errs} (tol {tol})")
                    n += 1
    log(f"[parity] flash_attention_bwd_dkv, flash_attention_bwd_dq: {n} "
        f"cases agree")


def _rel_err(got, want, scale=None) -> float:
    """max |got - want| over max |want| (or over max |scale|)."""
    want = want.float()
    scale = want if scale is None else scale.float()
    return ((got.float() - want).abs().max()
            / scale.abs().max().clamp_min(1e-30)).item()


def _kernel_entry(name, replaces, ms, plain_ms, flops, nbytes, peak, err,
                  library_ms, shape, **extra) -> dict:
    """One row of the kernels line. ``peak`` is a FLOP/s rate, or
    F32_PRODUCTS for f32 products: then the operations' time is the least
    of the CUDA cores' (67 TFLOP/s) and three TF32 products' (3 FLOP at
    495), and the CUDA cores' bound is kept beside it."""
    ops = ""
    if peak == F32_PRODUCTS:
        cores_ms = flops / PEAK_F32_FLOPS * 1e3
        tf32_ms = 3 * flops / PEAK_TF32_FLOPS * 1e3
        op_ms = min(cores_ms, tf32_ms)
        ops = " (3xTF32)" if tf32_ms <= cores_ms else " (CUDA cores)"
        extra["bound_ms_cuda_cores"] = max(cores_ms,
                                           nbytes / PEAK_BYTES * 1e3)
    else:
        op_ms = flops / peak * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return {"name": name, "route": "cuda",
            "source": f"deeplearning4j_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": None, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(op_ms, byte_ms),
            "bound_by": "operations" + ops if op_ms >= byte_ms else "bytes",
            "library_ms": library_ms, "shape": shape, **extra}


def train_shape_measure() -> list:
    """K3f, K3k and K3q at the training shape (B=4, H=4, T=2048, Dh=128,
    causal) in f32, the training path's type, and bf16: each kernel's time
    beside its plain version's, its bound, and torch's SDPA (forward for
    K3f; fwd+bwd minus fwd for the K3k+K3q pair), a yardstick the port
    never calls. The kernels and SDPA are timed by ``device_ms`` (each
    kernel by ``time_ms`` beside it, as ``ms_with_launch``); SDPA's
    backward is the ``device_ms`` of fwd+bwd minus that of fwd. Returns the
    entries of the kernels line, f32 then bf16."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    b, h, t, dh = TRAIN_B, N_HEADS, TRAIN_T, D_MODEL // N_HEADS
    pairs = b * h * t * t / 2 * dh * 2        # FLOPs of one causal product
    entries = []
    for dtype, peak in ((torch.float32, F32_PRODUCTS),
                        (torch.bfloat16, PEAK_BF16_FLOPS)):
        q, k, v = _qkv((b, h, t, dh), dtype, seed=21)
        do = _qkv((b, h, t, dh), dtype, seed=22)[0]
        elt = q.element_size()
        tile = b * h * t * dh * elt           # bytes of one (B,H,T,Dh) tensor
        row = b * h * t * 4                   # bytes of lse or delta
        o, lse = fa.flash_attention_fwd(q, k, v, True)
        delta = fa.attention_delta(o, do)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, True)
        dq = fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, True)
        ro, _ = fa.flash_attention_reference(q, k, v, True)
        rdq, rdk, rdv = fa.flash_attention_bwd_reference(q, k, v, o, lse,
                                                         do, True)
        err_fwd = (o.float() - ro.float()).abs().max().item()
        err_dkv = max((dk.float() - rdk.float()).abs().max().item(),
                      (dv.float() - rdv.float()).abs().max().item())
        err_dq = (dq.float() - rdq.float()).abs().max().item()

        def dkv():
            return fa.flash_attention_bwd_dkv(q, k, v, lse, do, delta, True)

        def dq_():
            return fa.flash_attention_bwd_dq(q, k, v, lse, do, delta, True)

        fwd_ms = device_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        fwd_host = time_ms(lambda: fa.flash_attention_fwd(q, k, v, True))
        dkv_ms, dkv_host = device_ms(dkv), time_ms(dkv)
        dq_ms, dq_host = device_ms(dq_), time_ms(dq_)
        fwd_plain = time_ms(lambda: fa.flash_attention_reference(
            q, k, v, True), reps=10)
        dkv_plain = time_ms(lambda: fa._bwd_dkv_plain(
            q, k, v, lse, do, delta, True), reps=10)
        dq_plain = time_ms(lambda: fa._bwd_dq_plain(
            q, k, v, lse, do, delta, True), reps=10)
        sdpa_fwd_dev = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), reps=20)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        sdpa_fwd_bwd = device_ms(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True),
            (qg, kg, vg), do), reps=20)
        sdpa_bwd = sdpa_fwd_bwd - sdpa_fwd_dev
        shape = f"B={b} H={h} T={t} Dh={dh} causal {str(dtype)[6:]}"
        pair_note = ("SDPA backward for the K3k+K3q pair (dq, dk, dv): "
                     "fwd+bwd minus fwd")
        group = [
            _kernel_entry("flash_attention_fwd",
                          "deeplearning4j_tpu/ops/flash_attention.py:405",
                          fwd_ms, fwd_plain, 2 * pairs, 4 * tile + row, peak,
                          err_fwd, sdpa_fwd_dev, shape,
                          ms_with_launch=fwd_host),
            _kernel_entry("flash_attention_bwd_dkv",
                          "jax/experimental/pallas/ops/tpu/"
                          "flash_attention.py:1121 (_flash_attention_bwd_dkv,"
                          " via deeplearning4j_tpu/ops/flash_attention.py:405)",
                          dkv_ms, dkv_plain, 4 * pairs, 6 * tile + 2 * row,
                          peak, err_dkv, sdpa_bwd, shape,
                          library_covers=pair_note, ms_with_launch=dkv_host),
            _kernel_entry("flash_attention_bwd_dq",
                          "jax/experimental/pallas/ops/tpu/"
                          "flash_attention.py:1456 (_flash_attention_bwd_dq,"
                          " via deeplearning4j_tpu/ops/flash_attention.py:405)",
                          dq_ms, dq_plain, 3 * pairs, 5 * tile + 2 * row,
                          peak, err_dq, sdpa_bwd, shape,
                          library_covers=pair_note, ms_with_launch=dq_host)]
        for e in group:
            log(f"[measure] {e['name']} {shape}: kernel {e['ms']:.4f} ms "
                f"({e['ms_with_launch']:.4f} ms with the host's launch in "
                f"the interval), plain {e['plain_ms']:.4f} ms, sdpa {e['library_ms']:.4f} "
                f"ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}"
                + (f"; CUDA cores {e['bound_ms_cuda_cores']:.4f} ms"
                   if "bound_ms_cuda_cores" in e else "")
                + f"); max abs err {e['max_abs_err']:.3g}")
        log(f"[measure] K3k+K3q {shape}: {dkv_ms + dq_ms:.4f} ms against "
            f"SDPA's backward {sdpa_bwd:.4f} ms (fwd+bwd {sdpa_fwd_bwd:.4f} "
            f"minus fwd {sdpa_fwd_dev:.4f}); bound "
            f"{group[1]['bound_ms'] + group[2]['bound_ms']:.4f} ms")
        entries += group
        del q, k, v, do, o, lse, delta, dk, dv, dq, ro, rdq, rdk, rdv
        torch.cuda.empty_cache()
    return entries


# ------------------------------------------------------------- phase 3 ----

def _prompt(rng, n):
    return [int(x) for x in rng.randint(0, VOCAB, n)]


def _kernel_admissions(engine, reqs) -> int:
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    impl = engine.attn_impl
    return sum((impl or resolve_attention_impl(r.bucket))
               in ("flash", "blockwise") for r in reqs)


def _self_us(event) -> float:
    """A profiler event's self time on the card, in us."""
    return (getattr(event, "self_device_time_total", None)
            or event.self_cuda_time_total)


def _by_name(prof, value) -> dict:
    """``value(event)`` of the profile's kernels on the card, summed by the
    first 60 characters of their names (template instances of one kernel
    share them), largest first."""
    from torch.autograd import DeviceType

    sums = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            sums[e.key[:60]] = sums.get(e.key[:60], 0) + value(e)
    return dict(sorted(sums.items(), key=lambda kv: kv[1], reverse=True))


def device_busy(prof, wall_s: float) -> dict:
    """Device busy time (sum of kernel self times on the card) against the
    run's wall time, and the kernels that take most of it."""
    by_name = _by_name(prof, _self_us)
    busy_ms = sum(by_name.values()) / 1e3
    return {"device_busy_ms": busy_ms, "wall_ms": wall_s * 1e3,
            "busy_share": busy_ms / (wall_s * 1e3),
            "top_kernels_ms": {k: us / 1e3
                               for k, us in list(by_name.items())[:6]}}


def serve(params, attn_impl, prompt_lens, seed, profiled=False) -> dict:
    """One engine, every request submitted before run_until_idle(); the
    kernel's launches are counted from 0 over exactly that run. With
    ``profiled`` the run goes under torch.profiler (its times then carry
    the profiler's cost) and the device busy share is reported."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    registry = MetricsRegistry()
    engine = DecodeEngine(params, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                          serve_dtype="bf16", attn_impl=attn_impl,
                          registry=registry, seed=seed, device=DEVICE)
    rng = np.random.RandomState(seed)
    # warm-up over the same buckets: the timed run then shows the steady
    # state, not each shape's first-use cost in the libraries below torch
    for n in prompt_lens:
        engine.submit(_prompt(rng, n), max_new_tokens=2)
    engine.run_until_idle()
    sync()
    decode_hist = registry.histogram("serve_decode_step_ms")
    d_count0, d_sum0 = decode_hist.count, decode_hist.sum
    prompts = [_prompt(rng, n) for n in prompt_lens]

    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    _kernels.reset_launches()
    with ctx as prof:
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
        engine.run_until_idle()
        sync()
        wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["flash_attention_fwd"]

    for r in reqs:
        if not (r.done.is_set() and r.finish_reason == "max_new_tokens"
                and len(r.generated) == MAX_NEW
                and all(0 <= tok < VOCAB for tok in r.generated)):
            raise AssertionError(f"request {r.rid} (prompt {len(r.prompt)}) "
                                 f"ended {r.finish_reason!r} with "
                                 f"{len(r.generated)} tokens")
    want = N_LAYERS * _kernel_admissions(engine, reqs)
    if launches != want:
        raise AssertionError(f"flash kernel launched {launches} times over "
                             f"the run, expected {want}")
    if want == 0:
        raise AssertionError("no admission resolved to the flash kernel")
    tokens = sum(len(r.generated) for r in reqs)
    by_bucket = {}
    for r in reqs:
        by_bucket.setdefault(r.bucket, []).append(r.prefill_ms)
    decode_steps = decode_hist.count - d_count0
    out = {"attn_impl": attn_impl, "profiled": profiled,
           "requests": len(reqs), "tokens": tokens,
           "wall_s": wall, "tokens_per_s": tokens / wall,
           "kernel_launches": launches, "kernel_admissions":
           want // N_LAYERS, "decode_steps": decode_steps,
           "decode_step_ms": (decode_hist.sum - d_sum0) / decode_steps,
           "prefill_ms_by_bucket": {b: statistics.mean(v)
                                    for b, v in sorted(by_bucket.items())}}
    if profiled:
        out.update(device_busy(prof, wall))
    log(f"[serve] {json.dumps(out)}")
    return out


def prefill_parity(params) -> None:
    """Prefill logits of one long prompt through the kernel and through
    dense attention at f32 (serve_dtype=None)."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import lm_prefill

    rng = np.random.RandomState(11)
    toks = torch.zeros((1, MAX_LEN), dtype=torch.int64, device=DEVICE)
    toks[0, :PARITY_LEN] = torch.tensor(_prompt(rng, PARITY_LEN))
    with torch.inference_mode():
        flash, fks, _ = lm_prefill(params, toks, N_HEADS, attn_impl="flash")
        dense, dks, _ = lm_prefill(params, toks, N_HEADS, attn_impl="dense")
    sync()
    err = (flash - dense).abs().max().item()
    kerr = (fks - dks).abs().max().item()
    agree = (flash[0, :PARITY_LEN].argmax(-1)
             == dense[0, :PARITY_LEN].argmax(-1)).float().mean().item()
    log(f"[parity] prefill logits T={MAX_LEN} (prompt {PARITY_LEN}) f32 "
        f"flash vs dense: max abs err {err:.3g} (ks {kerr:.3g}), greedy "
        f"agreement {agree:.4f}")
    if not (err <= 1e-3 and torch.isfinite(flash).all().item()):
        raise AssertionError(f"prefill logits flash vs dense differ by {err}")


# ------------------------------------------------------------ phase 3b ----

# the serving fast path at the flagship's width: 24 greedy requests, each
# one of 2 shared 1024-token system prefixes (64 pages of 16) and its own
# suffix of 16-900 tokens; request 0's suffix is 256 tokens, so its pages
# cover the whole prompt and its second admission is a full prefix hit
FP_REQUESTS, FP_PREFIX, FP_SUFFIX, FP_FULL_HIT_SUFFIX = 24, 1024, (16, 900), 256
# the bf16 timed runs take this many requests of the same mix, so each
# percentile rests on a few hundred latencies and thousands of gaps
FP_TIMED_REQUESTS = 192
FP_CHUNK, FP_SPEC_K, FP_DRAFT_LAYERS = 256, 4, 1
FP_ENGINES = ("plain", "prefix_cache", "speculative", "composed")
# offered load: this share of the rate the plain engine sustains
FP_LOAD = 0.5
# an f32 stream may leave the plain engine's only where the plain run's
# top-2 logits tie within this share of the largest |logit| there
FP_TIE = 1e-3
FP_SEED = 7         # the open-loop arrival schedule's
# what each run logs of its LoadReport
FP_REPORT = ("duration_s", "tokens_per_sec", "offered_rps",
             "first_token_p50_ms", "first_token_p99_ms", "latency_p50_ms",
             "latency_p99_ms", "inter_token_p50_ms", "inter_token_p99_ms")


def _fp_knobs(name: str) -> dict:
    from deeplearning4j_tpu_torch.serve import SpeculativeConfig

    spec = SpeculativeConfig(k=FP_SPEC_K, draft_layers=FP_DRAFT_LAYERS)
    return {"plain": {},
            "prefix_cache": {"prefix_cache": True},
            "speculative": {"speculative": spec},
            "composed": {"prefix_cache": True, "speculative": spec,
                         "prefill_chunk": FP_CHUNK}}[name]


def _fp_prompts(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    prefixes = [_prompt(rng, FP_PREFIX) for _ in range(2)]
    lens = rng.randint(FP_SUFFIX[0], FP_SUFFIX[1] + 1, n)
    lens[0] = FP_FULL_HIT_SUFFIX
    return [prefixes[i % 2] + _prompt(rng, int(n))
            for i, n in enumerate(lens)]


def _fp_engine(params, name: str, serve_dtype):
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    return DecodeEngine(params, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                        serve_dtype=serve_dtype, registry=MetricsRegistry(),
                        seed=5, device=DEVICE, **_fp_knobs(name))


def _fp_k3f_expected(engine, reqs) -> int:
    """K3f's launches for these requests: n_layers for each classic
    prefill (``bucket`` set) and draft_layers for each draft admission
    (every admission of a speculative engine, at the prompt's bucket),
    where the bucket resolves to the kernel."""
    from deeplearning4j_tpu_torch.models.transformer_lm import lm_n_layers
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    def kernel(bucket):
        return (engine.attn_impl or resolve_attention_impl(bucket)) in (
            "flash", "blockwise")

    want = N_LAYERS * sum(r.bucket is not None and kernel(r.bucket)
                          for r in reqs)
    if engine.spec is not None:
        want += lm_n_layers(engine._draft_params) * sum(
            kernel(engine.bucket_for(len(r.prompt))) for r in reqs)
    return want


def _fp_traffic(engine, name: str, prompts) -> tuple:
    """What the traffic fixes for engine ``name``, apart from the engine's
    own record: K3f's launch count and each admission mode's count (a
    range for the composed engine: a prompt that arrives while its
    prefix's first request is still chunking misses the cache). ``cold``
    is the number of distinct system prefixes; every prompt's bucket
    must resolve to the kernel, so a plain admission launches it once a
    layer and a draft admission once a draft layer."""
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    off = [len(p) for p in prompts
           if resolve_attention_impl(engine.bucket_for(len(p)))
           not in ("flash", "blockwise")]
    if off:
        raise AssertionError(f"fast path: prompts of {off} tokens do not "
                             f"admit at a kernel bucket")
    n, cold = len(prompts), len({tuple(p[:FP_PREFIX]) for p in prompts})
    dl = FP_DRAFT_LAYERS
    return {"plain": (N_LAYERS * n, {"full": (n, n)}),
            "prefix_cache": (N_LAYERS * cold, {"full": (cold, cold),
                                               "suffix": (n - cold,
                                                          n - cold)}),
            "speculative": ((N_LAYERS + dl) * n, {"full": (n, n)}),
            "composed": (dl * n, {"chunked": (cold, n),
                                  "suffix": (0, n - cold)})}[name]


def _fp_drive(engine, name, prompts, rate, profiled=False) -> dict:
    """``run_open_loop`` over ``prompts`` at ``rate``, the launches counted
    from 0 over exactly that run; every request must finish MAX_NEW
    tokens, K3f's count must be exact, non-zero and what the traffic
    fixes, and the admission modes must be those the traffic allows."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.serve import run_open_loop

    reqs, spec_ms = [], []
    submit, spec_step = engine.submit, engine._spec_step

    def recording_submit(*args, **kwargs):
        reqs.append(submit(*args, **kwargs))
        return reqs[-1]

    def timed_spec_step(*args):
        spec_ms.append(spec_step(*args))
        return spec_ms[-1]

    engine.submit, engine._spec_step = recording_submit, timed_spec_step
    verify = engine.registry.histogram("serve_verify_step_ms")
    decode = engine.registry.histogram("serve_decode_step_ms")
    v0, vn0, d0, dn0 = verify.sum, verify.count, decode.sum, decode.count
    prefix0 = engine._prefix.stats() if engine._prefix is not None else None
    spec0 = (engine.spec_accepted_total, engine._spec_proposed_total)
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    sync()
    _kernels.reset_launches()
    try:
        with ctx as prof:
            report = run_open_loop(engine, prompts, rate,
                                   max_new_tokens=MAX_NEW, seed=FP_SEED)
            sync()
    finally:
        engine.submit, engine._spec_step = submit, spec_step
    launches = _kernels.LAUNCHES["flash_attention_fwd"]
    for r in reqs:
        if not (r.done.is_set() and r.finish_reason == "max_new_tokens"
                and len(r.generated) == MAX_NEW):
            raise AssertionError(
                f"fast path: request {r.rid} (prompt {len(r.prompt)}) ended "
                f"{r.finish_reason!r} with {len(r.generated)} tokens")
    want = _fp_k3f_expected(engine, reqs)
    fixed, mode_range = _fp_traffic(engine, name, prompts)
    if launches != want or want != fixed or want == 0:
        raise AssertionError(f"fast path {name}: flash_attention_fwd "
                             f"launched {launches} times; the requests' "
                             f"records expect {want}, the traffic {fixed}")
    if engine._prefix is not None:
        engine._prefix.check_invariants()
    verify_n = verify.count - vn0
    rep = report.to_dict()
    by_mode = {}
    for r in reqs:
        by_mode.setdefault(_fp_mode(r), []).append(r)
    modes = {m: len(rs) for m, rs in by_mode.items()}
    if sum(modes.values()) != len(prompts) or any(
            not lo <= modes.get(m, 0) <= hi
            for m, (lo, hi) in mode_range.items()) or set(modes) - set(
            mode_range):
        raise AssertionError(f"fast path {name}: admission modes {modes}, "
                             f"the traffic allows {mode_range}")
    out = {**{k: rep[k] for k in FP_REPORT}, "k3f_launches": launches,
           "modes": modes,
           # host-clock means per admission mode: the page lookup and seed
           # (cached) and the prefill compute (suffix), fenced by its token
           "prefill_ms_by_mode": {
               m: {"cached": statistics.mean(r.prefill_cached_ms
                                             for r in rs),
                   "compute": statistics.mean(r.prefill_suffix_ms
                                              for r in rs)}
               for m, rs in by_mode.items()},
           "decode_steps": decode.count - dn0,
           "decode_step_ms": ((decode.sum - d0) / (decode.count - dn0)
                              if decode.count > dn0 else None)}
    if prefix0 is not None:
        now = engine._prefix.stats()
        lookups = now["lookups"] - prefix0["lookups"]
        out["prefix_hit_rate"] = (now["hits"] - prefix0["hits"]) / lookups
        out["prefix_pages"] = now["pages"]
        out["prefix_evictions"] = now["evictions"] - prefix0["evictions"]
    if engine.spec is not None:
        proposed = engine._spec_proposed_total - spec0[1]
        out["spec_accept_rate"] = ((engine.spec_accepted_total - spec0[0])
                                   / max(1, proposed))
    if verify_n:
        verify_ms = (verify.sum - v0) / verify_n
        out["verify_step_ms"] = verify_ms
        out["draft_ms_per_verify"] = sum(spec_ms) / verify_n - verify_ms
        out["plain_decode_ticks"] = decode.count - dn0 - verify_n
    if profiled:
        busy = device_busy(prof, report.duration_s)
        out.update(busy_share=busy["busy_share"],
                   device_busy_ms=busy["device_busy_ms"],
                   top_kernels_ms=dict(list(busy["top_kernels_ms"].items())[:4]))
    return {**out, "requests": reqs}


def _fp_mode(req) -> str:
    """How the prompt went in (the prefill span's ``mode``), read from the
    request's own record."""
    return ("full" if req.bucket is not None
            else "cached_full" if req.prefill_chunks == 0
            else "suffix" if req.cached_tokens else "chunked")


def _fp_divergence(params, prompt, want, got) -> tuple:
    """The first position where ``got`` leaves ``want``, and the top-2 gap
    of the logits there over the largest |logit|, from an f32 dense
    forward of the prompt and ``want``'s tokens before it; (None, None)
    when the streams agree."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import lm_prefill

    pos = next((i for i, (a, b) in enumerate(zip(want, got)) if a != b),
               None)
    if pos is None:
        return None, None
    toks = torch.tensor([prompt + want[:pos]], device=DEVICE)
    with torch.inference_mode():
        logits = lm_prefill(params, toks, N_HEADS, attn_impl="dense")[0]
    last = logits[0, -1].float()
    top = torch.topk(last, 2).values
    return pos, ((top[0] - top[1]) / last.abs().max()).item()


def _fp_full_hit(engine, prompt):
    """A prompt whose pages cover it, admitted twice: the second admission
    must add nothing to ``serve_prefill_dispatches_total``. Returns the
    second request."""
    counter = engine.registry.counter("serve_prefill_dispatches_total")
    engine.submit(prompt, max_new_tokens=MAX_NEW)
    engine.run_until_idle()
    before = counter.value
    req = engine.submit(prompt, max_new_tokens=MAX_NEW)
    engine.run_until_idle()
    if not (counter.value == before and req.cached_tokens == len(prompt)
            and req.prefill_chunks == 0 and req.bucket is None
            and len(req.generated) == MAX_NEW):
        raise AssertionError(
            f"full prefix hit ran a prefill: dispatches {before} -> "
            f"{counter.value}, cached_tokens {req.cached_tokens} of "
            f"{len(prompt)}")
    return req


def _fp_check_streams(params, name, prompts, want, got) -> list:
    """Each f32 stream of ``got`` equals ``want``'s, or leaves it where
    the plain run's top-2 logits tie within FP_TIE of the logit scale.
    Returns the requests that left it."""
    diverged = []
    for p, w, r in zip(prompts, want, got):
        pos, gap = _fp_divergence(params, p, w, r.generated)
        if pos is None:
            continue
        log(f"[fastpath] f32 {name}: request {r.rid} leaves the plain "
            f"stream at token {pos}; the plain run's top-2 gap there is "
            f"{gap:.3g} of its largest |logit|")
        diverged.append(r.rid)
        if not gap < FP_TIE:
            raise AssertionError(
                f"f32 {name}: request {r.rid} diverges at token {pos} "
                f"where the top-2 gap is {gap:.3g} of the logit scale (a "
                f"near-tie is < {FP_TIE})")
    return diverged


def _fp_trace_check(trace_dir, reqs) -> dict:
    """One ``serve.request`` tree per request, with its four children, and
    each prefill span's ``mode`` equal to the request's own record."""
    from tools.trace_report import load_trace_dir

    spans = load_trace_dir(trace_dir)
    kids = {}
    for sp in spans.values():
        kids.setdefault(sp.get("parent_id"), []).append(sp)
    trees = [sp for sp in spans.values() if sp["name"] == "serve.request"]
    by_rid = {sp["attrs"]["rid"]: sp for sp in trees}
    if sorted(by_rid) != sorted(r.rid for r in reqs) or \
            len(trees) != len(reqs):
        raise AssertionError(f"trace holds {len(trees)} serve.request "
                             f"trees for {len(reqs)} requests")
    modes = {}
    for r in reqs:
        children = {c["name"]: c for c in kids.get(by_rid[r.rid]["span_id"],
                                                   [])}
        if sorted(children) != ["serve.decode", "serve.prefill",
                                "serve.queue_wait", "serve.retire"]:
            raise AssertionError(f"request {r.rid}'s trace tree has "
                                 f"{sorted(children)}")
        mode = children["serve.prefill"]["attrs"]["mode"]
        if mode != _fp_mode(r):
            raise AssertionError(f"request {r.rid}: traced mode {mode}, "
                                 f"recorded {_fp_mode(r)}")
        modes[mode] = modes.get(mode, 0) + 1
    return {"trees": len(trees), "spans": len(spans), "modes": modes}


FP_STEP_WIDTHS = (64, 512, 1024)  # chunk widths a suffix admission takes


def fp_step_profile(params) -> dict:
    """A classic prefill (bucket MAX_LEN) and chunk steps of the widths a
    suffix admission takes, each alone on its cache, at f32 and bf16:
    host wall to the fenced token (median of 10) and, from one profiled
    call, the device time and kernel launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_kv_cache,
        make_chunk_prefill_step,
        make_prefill_step,
    )
    from deeplearning4j_tpu_torch.serve.quant import (
        activation_dtype,
        dequantize_tree,
        prepare_serve_params,
    )

    rng = np.random.RandomState(34)
    out = {}
    for serve_dtype in (None, "bf16"):
        p = prepare_serve_params(params, serve_dtype)
        cache = init_kv_cache(N_LAYERS, N_SLOTS, N_HEADS, D_MODEL // N_HEADS,
                              MAX_LEN, dtype=activation_dtype(serve_dtype),
                              device=DEVICE)
        prefill = make_prefill_step(N_HEADS, params_transform=dequantize_tree)
        chunk = make_chunk_prefill_step(N_HEADS,
                                        params_transform=dequantize_tree)
        gen = torch.Generator(device=DEVICE).manual_seed(0)
        temp = torch.tensor(0.0, device=DEVICE)
        full = torch.tensor([_prompt(rng, MAX_LEN)], device=DEVICE)
        calls = {f"classic {MAX_LEN}": lambda: int(prefill(
            p, cache, full, MAX_LEN - 1, 0, temp, gen)[1])}
        for w in FP_STEP_WIDTHS:
            toks = torch.tensor([_prompt(rng, w)], device=DEVICE)
            start = min(FP_PREFIX, MAX_LEN - w)
            calls[f"chunk {w}"] = lambda t=toks, s=start, w=w: int(chunk(
                p, cache, t, s, w - 1, 1, temp, gen)[1])
        row = {}
        for name, fn in calls.items():
            for _ in range(3):
                fn()
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                walls.append((time.perf_counter() - t0) * 1e3)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                sync()
            kernels = [e for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA]
            row[name] = {"host_ms": statistics.median(walls),
                         "device_ms": sum(map(_self_us, kernels)) / 1e3,
                         "kernels": sum(e.count for e in kernels)}
        out[serve_dtype or "f32"] = row
    log(f"[fastpath] prefill-shaped steps alone: {json.dumps(out)}")
    return out


def fastpath(params) -> dict:
    """Phase 3b: the same prompts and open-loop schedule through the plain
    engine, the prefix cache, speculative decoding and all three with
    chunked prefill; at f32 (traced, every stream held against the plain
    engine's) and at bf16 (timed over FP_TIMED_REQUESTS requests of the
    same mix)."""
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.telemetry import trace as tr

    prompts = _fp_prompts(31, FP_REQUESTS)
    timed = _fp_prompts(31, FP_TIMED_REQUESTS)
    warm = _fp_prompts(32, FP_REQUESTS)
    # the rate the plain engine sustains: the timed prompts in one burst
    # on a warmed bf16 engine
    plain = _fp_engine(params, "plain", "bf16")
    for p in warm:
        plain.submit(p, max_new_tokens=MAX_NEW)
    plain.run_until_idle()
    sync()
    t0 = time.perf_counter()
    for p in timed:
        plain.submit(p, max_new_tokens=MAX_NEW)
    plain.run_until_idle()
    sync()
    sustained = len(timed) / (time.perf_counter() - t0)
    rate = FP_LOAD * sustained
    log(f"[fastpath] plain bf16 engine sustains {sustained:.2f} requests/s "
        f"({len(timed)} in one burst); offered load {rate:.2f} requests/s")
    del plain

    # f32, TF32 off: every fast path's streams against the plain engine's
    f32 = {}
    work = tempfile.mkdtemp(prefix="dl4j_torch_fastpath_")
    try:
        for name in FP_ENGINES:
            engine = _fp_engine(params, name, None)
            trace_dir = f"{work}/{name}"
            tracer = tr.configure(f"fastpath-{name}", trace_dir,
                                  crash_hooks=False)
            try:
                run = _fp_drive(engine, name, prompts, rate)
            finally:
                tr.set_tracer(None)
                tracer.close()
            run["trace"] = _fp_trace_check(trace_dir, run["requests"])
            f32[name] = run
            want = [r.generated for r in f32["plain"]["requests"]]
            run["diverged_near_tie"] = _fp_check_streams(
                params, name, prompts, want, run["requests"])
            if engine._prefix is not None:
                hit = _fp_full_hit(engine, prompts[0])
                run["full_hit_diverged_near_tie"] = _fp_check_streams(
                    params, name, prompts[:1], want[:1], [hit])
                engine._prefix.check_invariants()
            log(f"[fastpath] f32 {name}: {json.dumps(_fp_summary(run))}")
            del engine
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # bf16: timed, each engine warmed by a burst of other prompts
    bf16 = {}
    for name in FP_ENGINES:
        engine = _fp_engine(params, name, "bf16")
        for p in warm:
            engine.submit(p, max_new_tokens=MAX_NEW)
        engine.run_until_idle()
        run = _fp_drive(engine, name, timed, rate)
        if name == "plain":
            want = [r.generated for r in run["requests"]]
        run["streams_equal_plain"] = sum(
            r.generated == w for r, w in zip(run["requests"], want)) / len(want)
        run["tokens_equal_plain"] = float(np.mean(
            [a == b for r, w in zip(run["requests"], want)
             for a, b in zip(r.generated, w)]))
        if name == "composed":
            run["profiled"] = _fp_summary(_fp_drive(
                engine, name, _fp_prompts(33, FP_REQUESTS), rate,
                profiled=True))
        bf16[name] = run
        log(f"[fastpath] bf16 {name}: {json.dumps(_fp_summary(run))}")
        del engine
        torch.cuda.empty_cache()
    return {"sustained_rps": sustained, "offered_rps": rate,
            "f32": {n: _fp_summary(r) for n, r in f32.items()},
            "bf16": {n: _fp_summary(r) for n, r in bf16.items()},
            "steps": fp_step_profile(params)}


def _fp_summary(run: dict) -> dict:
    return {k: v for k, v in run.items() if k != "requests"}


# ------------------------------------------------------------- phase 4 ----

def _train_setup(seed: int = 0):
    """Fresh f32 flagship params from a generator seeded ``seed`` and one
    (B, T) batch of tokens and next-token targets from a numpy seed."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    toks = np.random.RandomState(5).randint(0, VOCAB,
                                            (TRAIN_B, TRAIN_T + 1))
    toks = torch.as_tensor(toks, device=DEVICE)
    return params, toks[:, :-1], toks[:, 1:]


def _check_launches(run: str, steps: int) -> dict:
    from deeplearning4j_tpu_torch.ops import _kernels

    launches = dict(_kernels.LAUNCHES)
    want = N_LAYERS * steps
    for name in TRAIN_KERNELS:
        if launches[name] != want:
            raise AssertionError(f"{run}: {name} launched {launches[name]} "
                                 f"times, expected n_layers x steps = {want}")
    return launches


def train(profiled: bool = False) -> dict:
    """The flagship's single-device training step at full width with the
    auto attention core (the flash kernels at T=2048): 2 warm-up steps,
    then TRAIN_STEPS timed steps on one batch, launches counted from 0 over
    exactly those steps. With ``profiled`` the steps run under
    torch.profiler for the device busy share."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.transformer_lm import (
        make_single_device_train_step,
        selected_attn_impl,
    )
    from deeplearning4j_tpu_torch.ops import _kernels

    impl = selected_attn_impl(TRAIN_T, head_dim=D_MODEL // N_HEADS)
    if impl not in ("flash", "blockwise"):
        raise AssertionError(f"auto core at T={TRAIN_T} is {impl!r}")
    params, tokens, targets = _train_setup()
    step = make_single_device_train_step(N_HEADS, donate=True, device=DEVICE)
    for _ in range(2):
        params, loss = step(params, tokens, targets)
    sync()
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    _kernels.reset_launches()
    losses = []
    with ctx as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            params, loss = step(params, tokens, targets)
            losses.append(loss)
        sync()
        wall = time.perf_counter() - t0
    launches = _check_launches("training run", TRAIN_STEPS)
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite or not "
                             "falling")
    ms = wall * 1e3 / TRAIN_STEPS
    out = {"profiled": profiled, "attn_impl": impl, "steps": TRAIN_STEPS,
           "batch": [TRAIN_B, TRAIN_T], "wall_s": wall, "ms_per_step": ms,
           "samples_per_s": TRAIN_B * 1e3 / ms,
           "tokens_per_s": TRAIN_B * TRAIN_T * 1e3 / ms,
           "losses": losses, "launches": launches}
    if DEVICE == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profiled:
        out.update(device_busy(prof, wall))
    log(f"[train] {json.dumps(out)}")
    out["params"] = params
    return out


def grad_parity() -> None:
    """One step's loss and grads through the flash kernels
    (attn_impl="blockwise") against dense attention, f32 with TF32 off. The
    grads of wq, wk and wv must be non-zero in every layer: the first
    slice's flash output carried no graph, and those leaves got none.

    Both routes are also held against a float64 dense run on the same
    params and tokens, leaf by leaf, to attribute their gap (logged, not
    gated): if it comes from ReLU units of the expert FFNs at their kink,
    both f32 routes sit about equally far from float64 on the leaves fed
    by those units; if from the kernels, the kernel route sits farther."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        _get as _leaf,
        dense_loss_fn,
        lm_value_and_grad,
    )

    params, tokens, targets = _train_setup()
    kl, kg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="blockwise"),
                               params, tokens, targets)
    dl, dg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="dense"),
                               params, tokens, targets)
    loss_err = abs(float(kl) - float(dl))
    errs = {}
    tree_map(lambda path, g: errs.__setitem__(
        ".".join(path), _rel_err(g, _leaf(dg, path))), kg)
    grad_err = max(errs.values())
    log(f"[parity] grad rel err per leaf: {json.dumps(errs)}")
    f64_attribution(params, tokens, targets, kl, kg, dl, dg, errs)
    zero = [key for key in ("wq", "wk", "wv")
            if not bool((kg["blocks"][key].abs().amax((1, 2)) > 0).all())]
    finite = all(torch.isfinite(g).all().item() for g in tree_leaves(kg))
    log(f"[parity] training step flash kernels vs dense, f32, B={TRAIN_B} "
        f"T={TRAIN_T}: loss {float(kl):.6f} vs {float(dl):.6f} (abs err "
        f"{loss_err:.3g}), worst leaf grad rel err {grad_err:.3g}, "
        f"zero-grad attention leaves {zero}")
    if not (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and not zero
            and finite):
        raise AssertionError(
            f"kernel vs dense training step: loss err {loss_err} (tol "
            f"{LOSS_TOL}), grad rel err {grad_err} (tol {GRAD_TOL}), zero "
            f"grads {zero}, finite {finite}")


def f64_attribution(params, tokens, targets, kl, kg, dl, dg,
                    errs) -> None:
    """Each f32 route's loss and per-leaf grad error against one float64
    dense step on the same params and tokens (max abs error over the f64
    leaf's max); logged at the leaf where the two routes differ most
    (``errs``: kernels vs dense per leaf) and at each route's worst."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        _get as _leaf,
        dense_loss_fn,
        lm_value_and_grad,
    )

    p64 = tree_map(lambda _, x: x.double(), params)
    rl, rg = lm_value_and_grad(dense_loss_fn(N_HEADS, attn_impl="dense"),
                               p64, tokens, targets)
    del p64

    def err(g, path):
        want = _leaf(rg, path)
        return ((g.double() - want).abs().max()
                / want.abs().max().clamp_min(1e-300)).item()

    out = {"loss_f64": float(rl),
           "loss_err": {"kernels": abs(float(kl) - float(rl)),
                        "dense_f32": abs(float(dl) - float(rl))},
           "kernels": {}, "dense_f32": {}}
    tree_map(lambda path, g: out["kernels"].__setitem__(
        ".".join(map(str, path)), err(g, path)), kg)
    tree_map(lambda path, g: out["dense_f32"].__setitem__(
        ".".join(map(str, path)), err(g, path)), dg)
    worst = {route: max(out[route], key=out[route].get)
             for route in ("kernels", "dense_f32")}
    worst["kernels vs dense"] = max(errs, key=errs.get)
    log(f"[parity] f64 attribution, B={TRAIN_B} T={TRAIN_T}: "
        f"{json.dumps(out)}")
    for route, leaf in worst.items():
        log(f"[parity] f64 attribution: worst leaf of {route} is "
            f"{leaf}: kernels {out['kernels'][leaf]:.3g}, dense f32 "
            f"{out['dense_f32'][leaf]:.3g} of the f64 leaf's max")
    del rg
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


# a head dim the kernels refuse: the flagship's width in 2 heads of 256
WIDE_HEADS, WIDE_T = 2, 1024


def wide_head_step() -> None:
    """One training step of the LM at d_model / n_heads = 256, T=1024, with
    the auto core: T alone would pick the kernels, which take Dh up to 128,
    so auto must run dense attention, launch no flash kernel and give a
    finite loss and grads."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_lm_params,
        make_single_device_train_step,
        selected_attn_impl,
    )
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    head_dim = D_MODEL // WIDE_HEADS
    by_t = resolve_attention_impl(WIDE_T)
    impl = selected_attn_impl(WIDE_T, head_dim=head_dim)
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    params = init_lm_params(gen, VOCAB, D_MODEL, WIDE_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    toks = torch.as_tensor(np.random.RandomState(6).randint(
        0, VOCAB, (TRAIN_B, WIDE_T + 1)), device=DEVICE)
    step = make_single_device_train_step(WIDE_HEADS, device=DEVICE)
    _kernels.reset_launches()
    params, loss = step(params, toks[:, :-1], toks[:, 1:])
    sync()
    launches = {k: _kernels.LAUNCHES[k] for k in TRAIN_KERNELS}
    finite = (np.isfinite(float(loss))
              and all(torch.isfinite(p).all().item()
                      for p in tree_leaves(params)))
    out = {"head_dim": head_dim, "t": WIDE_T, "impl_by_t_alone": by_t,
           "impl": impl, "loss": float(loss), "launches": launches}
    log(f"[train] wide heads under auto: {json.dumps(out)}")
    if not (by_t == "blockwise" and impl == "dense" and finite
            and not any(launches.values())):
        raise AssertionError(f"Dh={head_dim} step under auto: {out}, "
                             f"finite {finite}")


def optimizer_path() -> None:
    """Two steps of the Adam step with the guard and metrics seams at full
    width, through the kernels, at Adam's usual rate ADAM_LR (the SGD
    default of 0.1 moves every weight by ~0.1 and throws the loss to ~2e4
    in one step)."""
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        init_lm_opt_state,
        make_single_device_train_step,
    )
    from deeplearning4j_tpu_torch.ops import _kernels

    params, tokens, targets = _train_setup()
    step = make_single_device_train_step(N_HEADS, ADAM_LR, optimizer="adam",
                                         guard=True, with_metrics=True,
                                         device=DEVICE)
    state = init_lm_opt_state("adam", params, device=DEVICE)
    _kernels.reset_launches()
    for _ in range(2):
        params, state, loss, metrics = step(params, state, tokens, targets)
    sync()
    _check_launches("adam run", 2)
    values = {k: v.tolist() for k, v in metrics.items()}
    log(f"[train] adam+guard+metrics, 2 steps: loss {float(loss):.6f}, "
        f"count {int(state['count'])}, metrics {json.dumps(values)}")
    missing = OPT_METRICS - set(metrics)
    if (missing or int(state["count"]) != 2 or values["nonfinite"] != 0.0
            or not np.isfinite(float(loss))
            or not all(np.isfinite(np.asarray(v)).all()
                       for v in values.values())):
        raise AssertionError(f"adam step: missing metrics {missing}, count "
                             f"{int(state['count'])}, metrics {values}")


# ------------------------------------------------------------- phase 5 ----

def _dense_inputs(m, k, n, dtype, seed, offset=0):
    """x, W, b as the MLP's layers see them; with ``offset`` x and W are
    views ``offset`` elements into their storage."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    x = torch.rand((m * k + offset,), generator=gen, device=DEVICE)
    w = torch.randn((k * n + offset,), generator=gen, device=DEVICE) / k ** 0.5
    b = torch.randn((n,), generator=gen, device=DEVICE) * 0.1
    return (x.to(dtype)[offset:].view(m, k), w.to(dtype)[offset:].view(k, n),
            b.to(dtype))


# K1's parity cases: ((M, K, N), element offset of x and W)
MLP_DENSE_CASES = (tuple((shape, 0) for shape in DENSE_SHAPES)
                   + tuple((shape, 1) for shape in DENSE_OFFSET_SHAPES))


def dense_parity(cases=MLP_DENSE_CASES) -> None:
    """K1 against ``fused_dense_reference`` on the card, every activation,
    f32 and bf16."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    n = 0
    for (m, k, nn), offset in cases:
        for act in pk._FUSABLE:
            for dtype in (torch.float32, torch.bfloat16):
                x, w, b = _dense_inputs(m, k, nn, dtype, seed=m + k + nn,
                                        offset=offset)
                got = pk.fused_dense_fwd(x, w, b, act)
                want = pk.fused_dense_reference(x, w, b, act)
                sync()
                tol = DENSE_TOL[str(dtype).split(".")[1]]
                err = _rel_err(got, want)
                ok = (got.dtype == dtype and tuple(got.shape) == (m, nn)
                      and err <= tol
                      and torch.isfinite(got.float()).all().item())
                log(f"[parity] fused_dense {m}x{k}x{nn} {act} {dtype}"
                    f"{f' offset {offset}' if offset else ''}: rel err "
                    f"{err:.3g} {'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError(
                        f"fused_dense kernel disagrees with its plain version "
                        f"at {m}x{k}x{nn} {act} {dtype} offset {offset}: "
                        f"{err} (tol {tol})")
                n += 1
    log(f"[parity] fused_dense: {n} cases agree")


# K1 at the MNIST MLP's hidden layers: (label, M, K, N, what the launches
# count); phase 9 passes LeNet's and conv_wide's dense layers
MLP_DENSE_LAYERS = tuple(
    (f"layer {i}", MLP_BATCH, k, n, "both MLP layers over the timed "
     "fit_epochs run")
    for i, (k, n) in enumerate(((784, MLP_H1), (MLP_H1, MLP_H2))))


def dense_measure(layers=MLP_DENSE_LAYERS) -> list:
    """K1 at each of ``layers`` (relu), f32 and bf16: its time, its plain
    version's, torch.relu(torch.addmm(b, x, w)) (two calls, a yardstick
    the port never calls), all by ``device_ms``, and the bound; beside
    them K1 by ``time_ms`` (host launch included). Operands stay resident
    in the 50 MB L2 between calls, as they are when the step has just
    written them. Returns the entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for layer, (label, m, k, n, cover) in enumerate(layers):
        for dtype, peak in ((torch.float32, F32_PRODUCTS),
                            (torch.bfloat16, PEAK_BF16_FLOPS)):
            x, w, b = _dense_inputs(m, k, n, dtype, seed=40 + layer)
            got = pk.fused_dense_fwd(x, w, b, "relu")
            want = pk.fused_dense_reference(x, w, b, "relu")
            err = (got.float() - want.float()).abs().max().item()
            ms = device_ms(lambda: pk.fused_dense_fwd(x, w, b, "relu"))
            plain = device_ms(lambda: pk.fused_dense_reference(x, w, b,
                                                               "relu"))
            lib = device_ms(lambda: torch.relu(torch.addmm(b, x, w)))
            host_ms = time_ms(lambda: pk.fused_dense_fwd(x, w, b, "relu"))
            elt = x.element_size()
            entry = _kernel_entry(
                "fused_dense", "deeplearning4j_tpu/ops/pallas_kernels.py:79",
                ms, plain, 2.0 * m * k * n, elt * (m * k + k * n + n + m * n),
                peak, err, lib,
                f"{label}: ({m},{k})@({k},{n}) relu {str(dtype)[6:]}",
                library_covers="torch.relu(torch.addmm(b, x, w)): two calls",
                launches_cover=cover, ms_with_launch=host_ms)
            log(f"[measure] fused_dense {entry['shape']}: kernel "
                f"{ms:.4f} ms ({host_ms:.4f} ms with the host's launch in "
                f"the interval), plain {plain:.4f} ms, addmm+relu "
                f"{lib:.4f} ms, "
                f"bound {entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}:"
                f" {2.0 * m * k * n / 1e9:.3f} GFLOP, "
                f"{elt * (m * k + k * n + n + m * n) / 1e6:.2f} MB); kernel "
                f"at {2.0 * m * k * n / ms / 1e9:.2f} TFLOP/s; max abs err "
                f"{err:.3g}")
            entries.append(entry)
    return entries


def _mnist(n: int, seed: int):
    """``n`` synthetic MNIST examples and one-hot labels (numpy)."""
    from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist

    x, y = synthetic_mnist(n, seed=seed)
    return x, np.eye(10, dtype=np.float32)[y]


def mlp_fit() -> dict:
    """The facade's main path: MultiLayerNetwork(mnist_mlp()).fit_epochs
    over a ListDataSetIterator at batch MLP_BATCH, MLP_WARMUP warm-up steps
    then MLP_STEPS timed steps (K1 counted from 0 over exactly those), then
    predict on HELD_OUT held-out examples (counted alone)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    b, w = MLP_BATCH, MLP_WARMUP
    x, y = _mnist(b * (w + MLP_STEPS), seed=7)
    net = MultiLayerNetwork(mnist_mlp(MLP_H1, MLP_H2), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    first = DataSet(x[w * b:(w + 1) * b], y[w * b:(w + 1) * b])
    score0 = net.score(first)
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    score1 = net.score(first)
    if launches != 2 * MLP_STEPS:
        raise AssertionError(f"fused_dense launched {launches} times over "
                             f"{MLP_STEPS} steps, expected 2 per step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"MLP score on the first timed batch "
                             f"{score0} -> {score1}: not finite or not "
                             "falling")
    hx, hy = _mnist(HELD_OUT, seed=8)
    _kernels.reset_launches()
    pred = net.predict(hx)
    predict_launches = _kernels.LAUNCHES["fused_dense"]
    accuracy = float((pred == hy.argmax(-1)).mean())
    if predict_launches != 2 or not accuracy > 0.9:
        raise AssertionError(f"predict: {predict_launches} launches "
                             f"(expected 2), accuracy {accuracy}")
    ms = wall * 1e3 / MLP_STEPS
    out = {"steps": MLP_STEPS, "batch": b, "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "score_first_batch": [score0, score1], "launches": launches,
           "predict_launches": predict_launches,
           "held_out_accuracy": accuracy}
    log(f"[mlp] fit_epochs {json.dumps(out)}")
    return out


# names of the device kernels only a convolution launches: cuDNN's, and the
# im2col route's unfold backward (its gather copy and products share
# their names with other layers' and are not counted here)
CONV_KERNEL_NAMES = re.compile(r"conv|cudnn|im2col|col2im|unfold|winograd|"
                               r"fprop|dgrad|wgrad", re.IGNORECASE)


def _profile_summary(prof, wall, steps) -> dict:
    """Busy share, device operations a step and the most frequent by
    name, and the convolution kernels' share of device time, by name."""
    out = device_busy(prof, wall)
    counts = _by_name(prof, lambda e: e.count)
    out["device_ops_per_step"] = sum(counts.values()) / steps
    out["device_ops_per_step_by_kernel"] = {
        k: n / steps for k, n in list(counts.items())[:10]}
    times = _by_name(prof, _self_us)
    conv = {k: us / 1e3 for k, us in times.items()
            if CONV_KERNEL_NAMES.search(k)}
    out["conv_kernels_device_ms"] = conv
    out["conv_share"] = sum(conv.values()) / max(out["device_busy_ms"], 1e-9)
    out["fused_dense_share"] = (_kernel_share(prof, "fused_dense")
                                / max(out["device_busy_ms"], 1e-9))
    return out


def train_chunk(name, conf, xs, ys, want_launches, bf16=False,
                profiled=False, tf32=False) -> dict:
    """make_train_epoch(conf, len(xs), donate=True) over one stacked chunk,
    as bench.measure builds it: a warm-up chunk, then one timed chunk with
    K1 counted from 0 over it (``want_launches`` exactly); the scores
    finite, and falling over the warm-up chunk. With ``profiled`` the
    timed chunk runs under torch.profiler; with ``tf32`` cuDNN may round
    f32 operands to TF32 (torch's default for convolutions) in both
    chunks."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.dtypes import BF16_COMPUTE

    steps = xs.shape[0]
    params = F.init_params(conf, 0, device=DEVICE)
    states = F.init_train_state(conf, params)
    epoch = F.make_train_epoch(conf, steps, donate=True,
                               policy=BF16_COMPUTE if bf16 else None)
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    tf32_before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        params, states, warm = epoch(params, states, 0, xs, ys, 1)
        warm = warm.tolist()
        _kernels.reset_launches()
        with ctx as prof:
            t0 = time.perf_counter()
            params, states, scores = epoch(params, states, steps, xs, ys, 2)
            sync()
            wall = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.allow_tf32 = tf32_before
    launches = _kernels.LAUNCHES["fused_dense"]
    scores = scores.tolist()
    if launches != want_launches:
        raise AssertionError(f"{name}: fused_dense launched {launches} times "
                             f"over a {steps}-step chunk, expected "
                             f"{want_launches}")
    if not (np.isfinite(warm + scores).all() and warm[-1] < warm[0]):
        raise AssertionError(f"{name} chunk scores not finite or not "
                             f"falling: {warm[0]} -> {warm[-1]}, "
                             f"{scores[-1]}")
    batch = xs.shape[1]
    ms = wall * 1e3 / steps
    out = {"model": name, "policy": "bf16" if bf16 else "f32",
           "cudnn_tf32": tf32, "profiled": profiled, "steps": steps,
           "batch": batch, "wall_s": wall, "ms_per_step": ms,
           "samples_per_s": batch * 1e3 / ms, "launches": launches,
           "first_chunk_scores": [warm[0], warm[-1]],
           "last_score": scores[-1]}
    if profiled:
        out.update(_profile_summary(prof, wall, steps))
    log(f"[{name}] train_epoch {json.dumps(out)}")
    return out


def mlp_epoch(bf16: bool, profiled: bool = False) -> dict:
    """``train_chunk`` of the MLP on one (EPOCH_STEPS, MLP_BATCH, 784)
    chunk of synthetic_mnist, as bench.measure("mlp") builds it: K1
    launches 2 a step."""
    import torch

    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp

    x, y = _mnist(MLP_BATCH * EPOCH_STEPS, seed=7)
    xs = torch.from_numpy(x).to(DEVICE).reshape(EPOCH_STEPS, MLP_BATCH, -1)
    ys = torch.from_numpy(y).to(DEVICE).reshape(EPOCH_STEPS, MLP_BATCH, -1)
    return train_chunk("mlp", mnist_mlp(MLP_H1, MLP_H2), xs, ys,
                       2 * EPOCH_STEPS, bf16=bf16, profiled=profiled)


def k1_grad_parity(name, conf, batch, seed) -> None:
    """One step's loss and grads (f32, TF32 off) through K1 against the
    plain dense route (set_fused_dense(False): pre_output + activation),
    from one set of params and one batch of synthetic_mnist: the MLP's
    limits (MLP_LOSS_TOL, MLP_GRAD_TOL); K1 launches twice (two relu
    dense layers), the plain route never."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _mnist(batch, seed))

    def loss_and_grads(fused):
        pk.set_fused_dense(fused)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads, _kernels.LAUNCHES["fused_dense"]

    try:
        kl, kg, k_launches = loss_and_grads(True)
        dl, dg, d_launches = loss_and_grads(False)
    finally:
        pk.set_fused_dense(None)
    names = [f"{i}.{key}" for i, layer in enumerate(params)
             for key in sorted(layer)]
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    loss_err = abs(kl - dl)
    log(f"[parity] {name} step K1 vs plain dense, f32, batch {batch}: loss "
        f"{kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), grad rel err per "
        f"leaf {json.dumps(errs)}; launches {k_launches} vs {d_launches}")
    if not (loss_err <= MLP_LOSS_TOL and max(errs.values()) <= MLP_GRAD_TOL
            and k_launches == 2 and d_launches == 0
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"{name} grads through K1 vs plain dense: loss "
                             f"err {loss_err} (tol {MLP_LOSS_TOL}), grad "
                             f"errs {errs} (tol {MLP_GRAD_TOL}), launches "
                             f"{k_launches}/{d_launches}")


def mlp() -> tuple:
    """Phase 5; returns K1's entries of the kernels line and the
    fit_epochs run."""
    dense_parity()
    entries = dense_measure()
    main_run = mlp_fit()
    for entry in entries:
        entry["launches"] = main_run["launches"]
        if "bfloat16" in entry["shape"]:
            entry["launches_cover"] += " (f32, the path's type)"
    mlp_epoch(bf16=False)
    mlp_epoch(bf16=True)
    mlp_epoch(bf16=False, profiled=True)
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp

    k1_grad_parity("MLP", mnist_mlp(MLP_H1, MLP_H2), MLP_BATCH, 9)
    return entries, main_run


# ------------------------------------------------------------- phase 6 ----

# the bench's widest char-LSTM, lstm_wide (bench.py:93, :203-206, :232-235):
# char_lstm(vocab=512), hidden 512, batch 64, sequence 64, chunk 8
LSTM_VOCAB, LSTM_BATCH, LSTM_SEQ, LSTM_CHUNK = 512, 64, 64, 8
LSTM_WARMUP, LSTM_STEPS = 2, 10
# fit_epochs's learning check trains at lr 0.01. At the zoo's lr 0.1,
# AdaGrad's near-sign first steps move every one of the 2.4M weights by
# ~0.1 and throw the score on random tokens far above ln(512), in both
# packages; the timed chunks keep the bench's conf (lr 0.1), whose speed
# does not depend on the rate
LSTM_FIT_LR = 0.01
# K2 parity shapes (B, H): both bench shapes (lstm_wide, lstm: bench.py:86,
# :203), the TPU gate's smallest, the widest H the TPU took, ragged ones;
# then the bench shapes from element-offset views (contiguous, aligned to
# one element only)
LSTM_CELL_SHAPES = ((64, 512), (256, 128), (8, 128), (100, 2048), (3, 10),
                    (1, 1))
LSTM_BENCH_SHAPES = ((LSTM_BATCH, LSTM_VOCAB), (256, 128))
# K2 against its plain version: at f32 within 1e-6 of max(1, |ref|) (both
# compute the same f32 ops with expf/tanhf, no fused multiply-add); at bf16
# within one bf16 step (2^-7 of the larger magnitude): both round one f32
# value once, which may differ in its last f32 ulp
CELL_F32_TOL, BF16_STEP = 1e-6, 2.0 ** -7
# ~25 f32 operations an element (3 sigmoids, 2 tanh, 3 products, 1 sum; a
# transcendental counted as 4): far below the bytes at any shape
CELL_OPS_PER_ELT = 25
# K2b, the cell's backward: the same 5 transcendentals, the sigmoids' sums
# and quotients and 22 products, sums and differences, ~48 an element; K2b
# moves 13 (B, H) streams (12 without dc_new), so bytes bound it too
CELL_BWD_OPS_PER_ELT = 48
# one LSTM step through K2 and K2b against set_lstm_gates(False), f32: loss
# absolute, grads as max abs error over the leaf's max (the two cells
# compute the same f32 ops; 64 timesteps of recurrence may carry an ulp)
LSTM_LOSS_TOL, LSTM_GRAD_TOL = 1e-5, 1e-4


def _one_hot_tokens(shape, vocab: int, seed: int):
    """Next-token data as bench.py:268-274 makes it: random tokens of
    ``shape + (seq + 1,)`` one-hot encoded; x the first seq, y the next
    (numpy f32)."""
    toks = np.random.RandomState(seed).randint(0, vocab, shape)
    eye = np.eye(vocab, dtype=np.float32)
    return eye[toks[..., :-1]], eye[toks[..., 1:]]


def _cell_inputs(b, h, ifog_dtype, c_dtype, seed, offset=0):
    """Random ifog (B, 4H) and c_prev (B, H); with ``offset`` each is a
    contiguous view ``offset`` elements into its storage."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ifog = 2 * torch.randn(b * 4 * h + offset, generator=gen, device=DEVICE)
    c = torch.randn(b * h + offset, generator=gen, device=DEVICE)
    return (ifog.to(ifog_dtype)[offset:].view(b, 4 * h),
            c.to(c_dtype)[offset:].view(b, h))


def _cell_grads(b, h, c_dtype, seed, last_step=False):
    """Random (dc_new, dh) in c's dtype. With ``last_step`` they come as the
    last timestep's reach K2b: dc_new None (autograd leaves it undefined)
    and dh a row view of a (B, 3, H) grad, row stride 3H (torch.stack's
    backward hands out such views)."""
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    dh = torch.randn((b, 3 if last_step else 1, h), generator=gen,
                     device=DEVICE).to(c_dtype)[:, -1]
    if last_step:
        return None, dh
    dc = torch.randn((b, h), generator=gen, device=DEVICE).to(c_dtype)
    return dc, dh.contiguous()


def _cell_bwd_bytes(ifog, c, dc) -> int:
    """Bytes K2b must move: ifog read and d_ifog written (4H each), c_prev,
    c_new, dh and dc_new (when given) read and dc_prev written."""
    b, h = c.shape
    streams = 5 if dc is not None else 4
    return b * h * (8 * ifog.element_size() + streams * c.element_size())


def _cell_err(got, want) -> tuple:
    """(max abs error, within tolerance) of one K2 or K2b output against
    the plain version's, by the output's dtype."""
    import torch

    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if got.dtype == torch.float32:
        ok = bool((diff <= CELL_F32_TOL * w.abs().clamp_min(1.0)).all())
    else:
        ok = bool((diff <= BF16_STEP * torch.maximum(g.abs(), w.abs())).all())
    return diff.max().item(), ok


def lstm_cell_parity() -> None:
    """K2 against ``lstm_gates_reference`` on the card at every shape of
    LSTM_CELL_SHAPES and at both bench shapes from element-offset views,
    for f32, bf16 and both mixes of input types."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    f32, bf16 = torch.float32, torch.bfloat16
    n = 0
    shapes = [(b, h, 0) for b, h in LSTM_CELL_SHAPES]
    shapes += [(b, h, 1) for b, h in LSTM_BENCH_SHAPES]
    for b, h, offset in shapes:
        for ifog_dt, c_dt in ((f32, f32), (bf16, bf16), (bf16, f32),
                              (f32, bf16)):
            ifog, c = _cell_inputs(b, h, ifog_dt, c_dt, seed=b + h,
                                   offset=offset)
            got = pk.lstm_gates_fwd(ifog, c)
            want = pk.lstm_gates_reference(ifog, c)
            sync()
            checks = [_cell_err(g, w) for g, w in zip(got, want)]
            ok = (all(c_ok for _, c_ok in checks)
                  and all(g.dtype == c_dt and tuple(g.shape) == (b, h)
                          and torch.isfinite(g.float()).all().item()
                          for g in got))
            log(f"[parity] lstm_gates B={b} H={h} ifog {str(ifog_dt)[6:]} "
                f"c {str(c_dt)[6:]}{f' offset {offset}' if offset else ''}: "
                f"max abs err c_new {checks[0][0]:.3g} "
                f"h_new {checks[1][0]:.3g} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lstm_gates kernel disagrees with its plain version at "
                    f"B={b} H={h} ifog {ifog_dt} c {c_dt} offset {offset}: "
                    f"{checks}")
            n += 1
    log(f"[parity] lstm_gates: {n} cases agree")


def lstm_cell_bwd_parity() -> None:
    """K2b against ``lstm_gates_bwd_reference`` on the card at every shape
    of LSTM_CELL_SHAPES, for f32, bf16 and both mixes of input types with
    random dc_new and dh, then at f32 and bf16 with the last timestep's
    grads (dc_new None, dh a strided row view). c_new is the plain
    forward's."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(f32, f32, False), (bf16, bf16, False), (bf16, f32, False),
             (f32, bf16, False), (f32, f32, True), (bf16, bf16, True)]
    n = 0
    for b, h in LSTM_CELL_SHAPES:
        for ifog_dt, c_dt, last in cases:
            ifog, c = _cell_inputs(b, h, ifog_dt, c_dt, seed=b + h)
            c_new, _ = pk.lstm_gates_reference(ifog, c)
            dc, dh = _cell_grads(b, h, c_dt, seed=b + 2 * h, last_step=last)
            got = pk.lstm_gates_bwd(ifog, c, c_new, dc, dh)
            want = pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh)
            sync()
            checks = [_cell_err(g, w) for g, w in zip(got, want)]
            ok = (all(c_ok for _, c_ok in checks)
                  and got[0].dtype == ifog_dt and got[1].dtype == c_dt
                  and tuple(got[0].shape) == (b, 4 * h)
                  and tuple(got[1].shape) == (b, h)
                  and all(torch.isfinite(g.float()).all().item()
                          for g in got))
            grads = ("dc_new None, dh row stride 3H" if last
                     else "random dc_new, dh")
            log(f"[parity] lstm_gates_bwd B={b} H={h} ifog "
                f"{str(ifog_dt)[6:]} c {str(c_dt)[6:]} ({grads}): max abs "
                f"err d_ifog {checks[0][0]:.3g} dc_prev {checks[1][0]:.3g} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(
                    f"lstm_gates_bwd kernel disagrees with its plain version "
                    f"at B={b} H={h} ifog {ifog_dt} c {c_dt} ({grads}): "
                    f"{checks}")
            n += 1
    log(f"[parity] lstm_gates_bwd: {n} cases agree")


def launch_floor() -> dict:
    """The floor under K2 and K2b: ``device_ms`` of an empty kernel that
    K2's library launches through the same ctypes path on K2's grid, at
    (1, 1) (one block) and at both bench shapes, and of K2 and K2b at
    (1, 1); beside them the empty launch by ``time_ms`` (the host's launch
    in the interval)."""
    import torch

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    lib = _kernels.load("lstm_gates")
    stream = torch.cuda.current_stream().cuda_stream

    def empty(b, h):
        rc = lib.dl4j_lstm_gates_empty(b, h, stream)
        if rc != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {rc}")

    out = {}
    for b, h in ((1, 1), *LSTM_BENCH_SHAPES):
        out[f"empty_{b}x{h}"] = device_ms(lambda: empty(b, h))
    out["empty_1x1_with_launch"] = time_ms(lambda: empty(1, 1))
    ifog, c = _cell_inputs(1, 1, torch.float32, torch.float32, seed=1)
    c_new, _ = pk.lstm_gates_reference(ifog, c)
    dc, dh = _cell_grads(1, 1, torch.float32, seed=2)
    out["lstm_gates_1x1"] = device_ms(lambda: pk.lstm_gates_fwd(ifog, c))
    out["lstm_gates_bwd_1x1"] = device_ms(
        lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc, dh))
    log(f"[measure] launch floor (ms, device_ms unless said) "
        f"{json.dumps(out)}")
    return out


def lstm_cell_measure(floor: dict) -> list:
    """K2 at both bench shapes, f32 (the training path's type) and bf16:
    its time, its plain version's and ATen's own CUDA LSTM cell's
    (``_thnn_fused_lstm_cell`` on pre-permuted i,f,g,o inputs with zero
    hidden gates, a yardstick the port never calls), all by ``device_ms``,
    and the bound; beside them K2 by ``time_ms`` (host launch included)
    and the empty kernel's ``device_ms`` on K2's grid (``launch_floor``).
    Returns the f32 entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for b, h in LSTM_BENCH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ifog, c = _cell_inputs(b, h, dtype, dtype, seed=50 + h)
            got = pk.lstm_gates_fwd(ifog, c)
            want = pk.lstm_gates_reference(ifog, c)
            err = max(_cell_err(g, w)[0] for g, w in zip(got, want))
            ms = device_ms(lambda: pk.lstm_gates_fwd(ifog, c))
            plain = device_ms(lambda: pk.lstm_gates_reference(ifog, c))
            host_ms = time_ms(lambda: pk.lstm_gates_fwd(ifog, c))
            gates = torch.cat([ifog[:, :2 * h], ifog[:, 3 * h:],
                               ifog[:, 2 * h:3 * h]], dim=1).contiguous()
            zeros = torch.zeros_like(gates)
            fused = getattr(torch.ops.aten, "_thnn_fused_lstm_cell", None)
            lib, lib_note = None, ("this torch has no "
                                   "aten._thnn_fused_lstm_cell")
            if fused is not None:
                lib = device_ms(lambda: fused(gates, zeros, c))
                lib_note = ("aten._thnn_fused_lstm_cell(input_gates, "
                            "hidden_gates=0, cx): gate order i,f,g,o, "
                            "inputs pre-permuted; reads one more (B, 4H)")
            elt = c.element_size()
            entry = _kernel_entry(
                "lstm_gates", "deeplearning4j_tpu/ops/pallas_kernels.py:176",
                ms, plain, float(CELL_OPS_PER_ELT * b * h), 7 * b * h * elt,
                PEAK_F32_FLOPS, err, lib,
                f"B={b} H={h} {str(dtype)[6:]}", library_covers=lib_note,
                launches_cover="64 timesteps x the timed fit_epochs steps",
                ms_with_launch=host_ms,
                launch_floor_ms=floor[f"empty_{b}x{h}"])
            log(f"[measure] lstm_gates {entry['shape']}: kernel {ms:.4f} ms "
                f"({host_ms:.4f} ms with the host's launch in the interval),"
                f" plain {plain:.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'}, bound "
                f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}: "
                f"{7 * b * h * elt / 1e6:.3f} MB); max abs err {err:.3g}")
            if dtype == torch.float32:
                entries.append(entry)
    return entries


def lstm_cell_bwd_measure(floor: dict) -> list:
    """K2b at both bench shapes, f32 and bf16, with random dc_new and dh:
    its time, its plain version's and ATen's own CUDA LSTM cell backward's
    (``_thnn_fused_lstm_cell_backward_impl`` on the activated gates in i,
    f, g, o order as its workspace, built outside the timed call: a
    yardstick the port never calls), all by ``device_ms``, and the bound;
    beside them K2b by ``time_ms`` and the launch floor. Returns the f32
    entries of the kernels line."""
    import torch

    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    entries = []
    for b, h in LSTM_BENCH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            ifog, c = _cell_inputs(b, h, dtype, dtype, seed=60 + h)
            c_new, _ = pk.lstm_gates_reference(ifog, c)
            dc, dh = _cell_grads(b, h, dtype, seed=61 + h)
            got = pk.lstm_gates_bwd(ifog, c, c_new, dc, dh)
            want = pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh)
            err = max(_cell_err(g, w)[0] for g, w in zip(got, want))
            ms = device_ms(lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc, dh))
            plain = device_ms(
                lambda: pk.lstm_gates_bwd_reference(ifog, c, c_new, dc, dh))
            host_ms = time_ms(lambda: pk.lstm_gates_bwd(ifog, c, c_new, dc,
                                                        dh))
            z = ifog.float()
            workspace = torch.cat(
                [torch.sigmoid(z[:, :2 * h]), torch.tanh(z[:, 3 * h:]),
                 torch.sigmoid(z[:, 2 * h:3 * h])], dim=1).to(dtype)
            fused = getattr(torch.ops.aten,
                            "_thnn_fused_lstm_cell_backward_impl", None)
            lib, lib_err, lib_note = None, None, (
                "this torch has no aten._thnn_fused_lstm_cell_backward_impl")
            if fused is not None:
                lib = device_ms(lambda: fused(dh, dc, c, c_new, workspace,
                                              False))
                lib_gates, lib_dc, _ = fused(dh, dc, c, c_new, workspace,
                                             False)
                # back to i, f, o, g: the same function up to gate order
                lib_ifog = torch.cat([lib_gates[:, :2 * h],
                                      lib_gates[:, 3 * h:],
                                      lib_gates[:, 2 * h:3 * h]], dim=1)
                lib_err = max(_rel_err(lib_ifog, want[0]),
                              _rel_err(lib_dc, want[1]))
                lib_note = ("aten._thnn_fused_lstm_cell_backward_impl(dh, "
                            "dc_new, c_prev, c_new, workspace, False): gate "
                            "order i,f,g,o, activated gates precomputed as "
                            "its workspace (K2b recomputes them from ifog)")
            nbytes = _cell_bwd_bytes(ifog, c, dc)
            entry = _kernel_entry(
                "lstm_gates_bwd",
                "deeplearning4j_tpu/ops/pallas_kernels.py:240",
                ms, plain, float(CELL_BWD_OPS_PER_ELT * b * h), nbytes,
                PEAK_F32_FLOPS, err, lib, f"B={b} H={h} {str(dtype)[6:]}",
                replaces_note=("_lstm_gates_bwd, the lax backward of K2 that "
                               "XLA fuses: no pallas_call"),
                library_covers=lib_note, library_rel_err=lib_err,
                launches_cover="64 timesteps x the timed fit_epochs steps",
                ms_with_launch=host_ms,
                launch_floor_ms=floor[f"empty_{b}x{h}"])
            log(f"[measure] lstm_gates_bwd {entry['shape']}: kernel "
                f"{ms:.4f} ms ({host_ms:.4f} ms with the host's launch in the"
                f" interval), plain {plain:.4f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.4f} ms'} (its outputs "
                f"{'n/a' if lib_err is None else f'{lib_err:.3g}'} from "
                f"the plain version's, relative), bound "
                f"{entry['bound_ms'] * 1e3:.3f} us ({entry['bound_by']}: "
                f"{nbytes / 1e6:.3f} MB), launch floor "
                f"{entry['launch_floor_ms']:.4f} ms; max abs err {err:.3g}")
            if dtype == torch.float32:
                entries.append(entry)
    return entries


def _lstm_conf(lr: float = 0.1):  # the zoo's rate
    from deeplearning4j_tpu_torch.models.zoo import char_lstm

    return char_lstm(vocab=LSTM_VOCAB, lr=lr)


def lstm_fit() -> dict:
    """The facade's main path on the char-LSTM: MultiLayerNetwork
    .fit_epochs over a ListDataSetIterator at batch 64, LSTM_WARMUP warm-up
    steps then LSTM_STEPS timed steps (K2 and K2b counted from 0 over
    exactly those: 64 each a step), then predict on a held-out batch
    (counted alone: 64 K2 launches, no K2b)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    b, w = LSTM_BATCH, LSTM_WARMUP
    x, y = _one_hot_tokens((b * (w + LSTM_STEPS), LSTM_SEQ + 1), LSTM_VOCAB,
                           seed=7)
    net = MultiLayerNetwork(_lstm_conf(LSTM_FIT_LR), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    first = DataSet(x[w * b:(w + 1) * b], y[w * b:(w + 1) * b])
    score0 = net.score(first)
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["lstm_gates"]
    bwd_launches = _kernels.LAUNCHES["lstm_gates_bwd"]
    score1 = net.score(first)
    for name, n in (("lstm_gates", launches),
                    ("lstm_gates_bwd", bwd_launches)):
        if n != LSTM_SEQ * LSTM_STEPS:
            raise AssertionError(f"{name} launched {n} times over "
                                 f"{LSTM_STEPS} steps, expected {LSTM_SEQ} "
                                 "per step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"LSTM score on the first timed batch "
                             f"{score0} -> {score1}: not finite or not "
                             "falling")
    hx, _ = _one_hot_tokens((b, LSTM_SEQ + 1), LSTM_VOCAB, seed=8)
    _kernels.reset_launches()
    pred = net.predict(hx)
    predict_launches = _kernels.LAUNCHES["lstm_gates"]
    predict_bwd = _kernels.LAUNCHES["lstm_gates_bwd"]
    if (predict_launches != LSTM_SEQ or predict_bwd != 0
            or pred.shape != (b, LSTM_SEQ)):
        raise AssertionError(f"predict: {predict_launches} K2 launches "
                             f"(expected {LSTM_SEQ}), {predict_bwd} K2b "
                             f"(expected 0), shape {pred.shape}")
    ms = wall * 1e3 / LSTM_STEPS
    out = {"steps": LSTM_STEPS, "batch": [b, LSTM_SEQ], "lr": LSTM_FIT_LR,
           "wall_s": wall, "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "tokens_per_s": b * LSTM_SEQ * 1e3 / ms,
           "score_first_batch": [score0, score1], "launches": launches,
           "bwd_launches": bwd_launches, "predict_launches": predict_launches,
           "predict_bwd_launches": predict_bwd,
           "predict_shape": list(pred.shape)}
    log(f"[lstm] fit_epochs {json.dumps(out)}")
    return out


def _kernel_share(prof, name: str) -> float:
    """Device ms of the kernels whose name holds ``name``."""
    from torch.autograd import DeviceType

    return sum(_self_us(e) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and name in e.key) / 1e3


def lstm_epoch(bf16: bool, kernels: bool = True,
               profiled: bool = False) -> dict:
    """make_train_epoch(conf, 8, donate=True) on one (8, 64, 64, 512) chunk
    of one-hot tokens, as bench.measure("lstm_wide") builds it: a warm-up
    chunk, then one timed chunk with K2 and K2b counted from 0 over it.
    With ``kernels=False`` the chunk runs with set_lstm_gates(False), the
    bench's ``_nokernels`` twin: neither launches. With ``profiled`` the
    timed chunk runs under torch.profiler for the busy share, the device
    operations a step (the most frequent by name) and K2's and K2b's
    shares."""
    import contextlib

    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk
    from deeplearning4j_tpu_torch.ops.dtypes import BF16_COMPUTE

    conf = _lstm_conf()
    params = F.init_params(conf, 0, device=DEVICE)
    states = F.init_train_state(conf, params)
    epoch = F.make_train_epoch(conf, LSTM_CHUNK, donate=True,
                               policy=BF16_COMPUTE if bf16 else None)
    x, y = _one_hot_tokens((LSTM_CHUNK, LSTM_BATCH, LSTM_SEQ + 1),
                           LSTM_VOCAB, seed=2)
    xs, ys = (torch.from_numpy(a).to(DEVICE) for a in (x, y))
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    pk.set_lstm_gates(kernels)
    try:
        params, states, warm = epoch(params, states, 0, xs, ys, 1)
        warm = warm.tolist()
        _kernels.reset_launches()
        with ctx as prof:
            t0 = time.perf_counter()
            params, states, scores = epoch(params, states, LSTM_CHUNK, xs,
                                           ys, 2)
            sync()
            wall = time.perf_counter() - t0
    finally:
        pk.set_lstm_gates(None)
    launches = _kernels.LAUNCHES["lstm_gates"]
    bwd_launches = _kernels.LAUNCHES["lstm_gates_bwd"]
    scores = scores.tolist()
    want = LSTM_SEQ * LSTM_CHUNK if kernels else 0
    for name, n in (("lstm_gates", launches),
                    ("lstm_gates_bwd", bwd_launches)):
        if n != want:
            raise AssertionError(f"{name} launched {n} times over a "
                                 f"{LSTM_CHUNK}-step chunk, expected {want}")
    if not np.isfinite(warm + scores).all():
        raise AssertionError(f"LSTM epoch scores not finite: {warm}, "
                             f"{scores}")
    ms = wall * 1e3 / LSTM_CHUNK
    out = {"policy": "bf16" if bf16 else "f32", "kernels": kernels,
           "profiled": profiled, "steps": LSTM_CHUNK,
           "batch": [LSTM_BATCH, LSTM_SEQ], "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": LSTM_BATCH * 1e3 / ms,
           "tokens_per_s": LSTM_BATCH * LSTM_SEQ * 1e3 / ms,
           "launches": launches, "bwd_launches": bwd_launches,
           "scores": warm + scores}
    if profiled:
        out.update(device_busy(prof, wall))
        counts = _by_name(prof, lambda e: e.count)
        out["device_ops_per_step"] = sum(counts.values()) / LSTM_CHUNK
        out["device_ops_per_step_by_kernel"] = {
            k: n / LSTM_CHUNK for k, n in list(counts.items())[:10]}
        for name in ("lstm_gates", "lstm_gates_bwd"):
            out[f"{name}_device_ms"] = _kernel_share(prof, f"{name}_kernel")
            out[f"{name}_share"] = (out[f"{name}_device_ms"]
                                    / max(out["device_busy_ms"], 1e-9))
    log(f"[lstm] train_epoch {json.dumps(out)}")
    return out


def lstm_grad_parity() -> None:
    """One char-LSTM step's loss and grads (batch 64, sequence 64, f32, TF32
    off) through K2 and K2b against set_lstm_gates(False) (the plain cell,
    forward and backward), from one set of params and one batch."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import pallas_kernels as pk

    conf = _lstm_conf()
    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _one_hot_tokens(
        (LSTM_BATCH, LSTM_SEQ + 1), LSTM_VOCAB, seed=9))

    def loss_and_grads(kernel):
        pk.set_lstm_gates(kernel)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), grads, (
            _kernels.LAUNCHES["lstm_gates"],
            _kernels.LAUNCHES["lstm_gates_bwd"])

    try:
        kl, kg, k_launches = loss_and_grads(True)
        dl, dg, d_launches = loss_and_grads(False)
    finally:
        pk.set_lstm_gates(None)
    names = sorted(params[0])
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    loss_err = abs(kl - dl)
    log(f"[parity] LSTM step K2+K2b vs plain cell, f32, batch {LSTM_BATCH}x"
        f"{LSTM_SEQ}: loss {kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), "
        f"grad rel err per leaf {json.dumps(errs)}; launches {k_launches} "
        f"vs {d_launches}")
    if not (loss_err <= LSTM_LOSS_TOL and max(errs.values()) <= LSTM_GRAD_TOL
            and k_launches == (LSTM_SEQ, LSTM_SEQ)
            and d_launches == (0, 0)
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"LSTM grads through K2+K2b vs plain cell: loss "
                             f"err {loss_err} (tol {LSTM_LOSS_TOL}), grad errs "
                             f"{errs} (tol {LSTM_GRAD_TOL}), launches "
                             f"{k_launches}/{d_launches}")


def lstm() -> list:
    """Phase 6; returns K2's and K2b's entries of the kernels line."""
    lstm_cell_parity()
    lstm_cell_bwd_parity()
    floor = launch_floor()
    entries = lstm_cell_measure(floor)
    bwd_entries = lstm_cell_bwd_measure(floor)
    main_run = lstm_fit()
    for entry in entries:
        entry["launches"] = main_run["launches"]
    for entry in bwd_entries:
        entry["launches"] = main_run["bwd_launches"]
    lstm_epoch(bf16=False)
    lstm_epoch(bf16=True)
    lstm_epoch(bf16=False, kernels=False)
    lstm_epoch(bf16=False, profiled=True)
    lstm_epoch(bf16=False, kernels=False, profiled=True)
    lstm_grad_parity()
    return entries + bwd_entries


# ------------------------------------------------------------- phase 7 ----

# the bench's long-context attention char-LM, attn_long (bench.py:97, :204,
# :239-241): char_attention_lm(vocab=128, d_model=512, n_heads=4,
# num_iterations=1), batch 4, T=2048
ATTN_VOCAB, ATTN_D, ATTN_HEADS, ATTN_B, ATTN_T = 128, 512, 4, 4, 2048
ATTN_WARMUP, ATTN_STEPS = 2, 5
# kernels vs dense attention, one step at f32: loss absolute, grads as max
# abs error over the leaf's max. No ReLU in this model (linear embedding),
# so no kink flips: the difference is the summation order of the kernels
# (their parity tolerance is 1e-4 of the max) carried through the block
ATTN_LOSS_TOL, ATTN_GRAD_TOL = 1e-4, 1e-3


def _attn_conf():
    from deeplearning4j_tpu_torch.models.zoo import char_attention_lm

    return char_attention_lm(vocab=ATTN_VOCAB, d_model=ATTN_D,
                             n_heads=ATTN_HEADS, num_iterations=1)


def attn_lm_fit() -> dict:
    """MultiLayerNetwork.fit_epochs on the attention char-LM at batch 4,
    T=2048 with the auto core: ATTN_WARMUP warm-up steps then ATTN_STEPS
    timed steps, K3f, K3k and K3q each counted from 0 over exactly those
    (once a step: one attention layer); then ``output`` on one batch (one
    K3f launch)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops.flash_attention import (
        resolve_attention_impl,
    )

    impl = resolve_attention_impl(ATTN_T)
    if impl not in ("flash", "blockwise"):
        raise AssertionError(f"auto core at T={ATTN_T} is {impl!r}")
    b, w = ATTN_B, ATTN_WARMUP
    x, y = _one_hot_tokens((b * (w + ATTN_STEPS), ATTN_T + 1), ATTN_VOCAB,
                           seed=11)
    net = MultiLayerNetwork(_attn_conf(), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    for name in TRAIN_KERNELS:
        if launches[name] != ATTN_STEPS:
            raise AssertionError(f"attention LM: {name} launched "
                                 f"{launches[name]} times over {ATTN_STEPS} "
                                 "steps, expected once a step")
    score = net.score(DataSet(x[:b], y[:b]))
    _kernels.reset_launches()
    out_logits = net.output(x[:b])
    sync()
    out_launches = dict(_kernels.LAUNCHES)
    if not (np.isfinite(score)
            and tuple(out_logits.shape) == (b, ATTN_T, ATTN_VOCAB)
            and bool(out_logits.isfinite().all())
            and out_launches["flash_attention_fwd"] == 1
            and out_launches["flash_attention_bwd_dkv"] == 0
            and out_launches["flash_attention_bwd_dq"] == 0):
        raise AssertionError(f"attention LM output: score {score}, shape "
                             f"{tuple(out_logits.shape)}, launches "
                             f"{out_launches}")
    ms = wall * 1e3 / ATTN_STEPS
    out = {"attn_impl": impl, "steps": ATTN_STEPS, "batch": [b, ATTN_T],
           "wall_s": wall, "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "tokens_per_s": b * ATTN_T * 1e3 / ms, "score": score,
           "launches": {k: launches[k] for k in TRAIN_KERNELS},
           "output_launches": {k: out_launches[k] for k in TRAIN_KERNELS}}
    log(f"[attn] fit_epochs {json.dumps(out)}")
    return out


def attn_lm_grad_parity() -> None:
    """One attention-LM step's loss and grads (batch 4, T=2048, f32, TF32
    off) through the kernels (the auto core) against
    set_attention_impl("dense"), with non-zero grads for wq, wk and wv."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as fa

    conf = _attn_conf()
    params = F.init_params(conf, 3, device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in _one_hot_tokens(
        (ATTN_B, ATTN_T + 1), ATTN_VOCAB, seed=12))

    def loss_and_grads(impl):
        fa.set_attention_impl(impl)
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        _kernels.reset_launches()
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        grads = torch.autograd.grad(loss, leaves)
        return (float(loss.detach()), grads,
                sum(_kernels.LAUNCHES[k] for k in TRAIN_KERNELS))

    try:
        kl, kg, k_launches = loss_and_grads(None)
        dl, dg, d_launches = loss_and_grads("dense")
    finally:
        fa.set_attention_impl(None)
    names = [f"{i}.{key}" for i in range(conf.n_layers)
             for key in sorted(params[i])]
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, kg, dg)}
    zero = [n for n, g in zip(names, kg)
            if n.split(".")[1] in ("wq", "wk", "wv")
            and not bool(g.abs().max() > 0)]
    loss_err = abs(kl - dl)
    log(f"[parity] attention LM step kernels vs dense, f32, B={ATTN_B} "
        f"T={ATTN_T}: loss {kl:.7f} vs {dl:.7f} (abs err {loss_err:.3g}), "
        f"grad rel err per leaf {json.dumps(errs)}; launches {k_launches} "
        f"vs {d_launches}; zero-grad attention leaves {zero}")
    if not (loss_err <= ATTN_LOSS_TOL and max(errs.values()) <= ATTN_GRAD_TOL
            and not zero and k_launches == 3 and d_launches == 0
            and all(torch.isfinite(g).all().item() for g in kg)):
        raise AssertionError(f"attention LM grads, kernels vs dense: loss "
                             f"err {loss_err} (tol {ATTN_LOSS_TOL}), grad "
                             f"errs {errs} (tol {ATTN_GRAD_TOL}), zero "
                             f"{zero}, launches {k_launches}/{d_launches}")


def attn_lm() -> dict:
    """Phase 7."""
    out = attn_lm_fit()
    attn_lm_grad_parity()
    return out


# ------------------------------------------------------------- phase 8 ----

# the CLI's MLP run: synthetic_mnist CSVs (784 features, then the label)
CLI_TRAIN_ROWS, CLI_HELD_OUT, CLI_EPOCHS = 4096, 1024, 2
CKPT_STEP = TRAIN_STEPS + 2  # the trained params' step count


def _cli(argv) -> tuple:
    """``cli.driver.main(argv)`` in process, which must return 0: (stdout,
    wall seconds)."""
    import contextlib
    import io

    from deeplearning4j_tpu_torch.cli.driver import main as cli_main

    buf = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main([str(a) for a in argv])
    sync()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"cli {argv[0]} exited {rc}")
    return buf.getvalue(), wall


def ckpt_round_trip(params, work) -> dict:
    """The trained flagship params saved by Checkpointer (meta from
    lm_checkpoint_meta) and restored onto the card from the manifest alone,
    every leaf torch.equal to what was saved; the same for a bf16 copy.
    Returns each copy's root, save and restore ms and bytes."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models.transformer_lm import (
        lm_checkpoint_meta,
    )
    from deeplearning4j_tpu_torch.scaleout.ckpt import (
        Checkpointer,
        read_manifest,
        template_from_manifest,
    )
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    out = {}
    for name, tree in (("f32", params),
                       ("bf16", tree_map(lambda _, x: x.to(torch.bfloat16),
                                         params))):
        root = f"{work}/lm_ckpt_{name}"
        ck = Checkpointer(root, registry=MetricsRegistry())
        sync()
        t0 = time.perf_counter()
        step_dir = ck.save(CKPT_STEP, {"params": tree},
                           meta=lm_checkpoint_meta(tree, N_HEADS))
        save_ms = (time.perf_counter() - t0) * 1e3
        manifest = read_manifest(step_dir)
        template = template_from_manifest(manifest)
        t0 = time.perf_counter()
        state, step, meta = ck.restore(template, device=DEVICE)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
        got, want = tree_leaves(state["params"]), tree_leaves(tree)
        if not (step == CKPT_STEP and meta["lm"]["n_heads"] == N_HEADS
                and len(got) == len(want) == len(manifest.leaves)
                and all(g.device.type == DEVICE and torch.equal(g, w)
                        for g, w in zip(got, want))):
            raise AssertionError(f"checkpoint round trip ({name}) is not "
                                 "leaf for leaf equal on the card")
        out[name] = {"root": root, "save_ms": save_ms,
                     "restore_ms": restore_ms,
                     "bytes": manifest.total_bytes,
                     "leaves": len(manifest.leaves)}
    log(f"[ckpt] {json.dumps(out)}")
    return out


def cli_predict_lm(params, root, work, direct_tokens_per_s) -> dict:
    """``predict --model <ckpt_dir>`` at the flagship's serving knobs
    (max-len 2048, 8 slots, 16 new tokens, bf16), in process with the
    launches counted from 0: K3f launches n_layers x the admissions whose
    bucket resolves to it, and the rows equal a direct DecodeEngine's on
    the same params and knobs, whose one run on a fresh engine is timed
    (phase 3's engine is timed after a warm-up). The command runs twice (each run builds its
    engine anew, as a user's does); ``DecodeEngine.from_checkpoint`` alone
    is timed beside it. Then the same command once as ``python -m
    deeplearning4j_tpu_torch.cli.driver``: exit 0, the same file."""
    from pathlib import Path

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.telemetry.registry import default_registry

    rng = np.random.RandomState(21)
    prompts = [_prompt(rng, n) for n in PROMPT_LENS]
    prompts_path = f"{work}/prompts.txt"
    with open(prompts_path, "w") as f:
        f.write("\n".join(" ".join(map(str, p)) for p in prompts) + "\n")
    argv = ["predict", "--model", root, "--input", prompts_path,
            "--max-len", MAX_LEN, "--slots", N_SLOTS, "--max-new-tokens",
            MAX_NEW, "--serve-dtype", "bf16", "--device", DEVICE]
    direct = DecodeEngine(params, N_HEADS, n_slots=N_SLOTS, max_len=MAX_LEN,
                          serve_dtype="bf16", seed=0, device=DEVICE)
    sync()
    t0 = time.perf_counter()
    reqs = [direct.submit(p, max_new_tokens=MAX_NEW) for p in prompts]
    direct.run_until_idle()
    sync()
    fresh_s = time.perf_counter() - t0
    want = N_LAYERS * _kernel_admissions(direct, reqs)
    reg = default_registry()
    walls, engine_ms = [], []
    for _ in range(2):
        prefill0 = reg.histogram("serve_prefill_ms").sum
        decode0 = reg.histogram("serve_decode_step_ms").sum
        _kernels.reset_launches()
        _, wall = _cli(argv + ["--output", f"{work}/gen.txt"])
        launches = dict(_kernels.LAUNCHES)
        walls.append(wall)
        engine_ms.append(reg.histogram("serve_prefill_ms").sum - prefill0
                         + reg.histogram("serve_decode_step_ms").sum
                         - decode0)
        with open(f"{work}/gen.txt") as f:
            rows = [[int(t) for t in line.split()] for line in f]
        if launches["flash_attention_fwd"] != want or want == 0:
            raise AssertionError(
                f"cli predict: flash_attention_fwd launched "
                f"{launches['flash_attention_fwd']} times, expected "
                f"n_layers x flash admissions = {want}")
        if rows != [r.generated for r in reqs] or \
                any(len(r) != MAX_NEW for r in rows):
            raise AssertionError("cli predict rows differ from a direct "
                                 "DecodeEngine's on the same params")
    sync()
    t0 = time.perf_counter()
    DecodeEngine.from_checkpoint(root, n_slots=N_SLOTS, max_len=MAX_LEN,
                                 serve_dtype="bf16", device=DEVICE)
    sync()
    load_s = time.perf_counter() - t0

    repo = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli.driver",
         *map(str, argv), "--output", f"{work}/gen_sub.txt"],
        cwd=str(repo), capture_output=True, text=True, timeout=300)
    sub_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"python -m deeplearning4j_tpu_torch.cli.driver"
                             f" predict exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    with open(f"{work}/gen_sub.txt") as f, open(f"{work}/gen.txt") as g:
        if f.read() != g.read():
            raise AssertionError("the subprocess CLI's rows differ from the "
                                 "in-process run's")
    tokens = sum(len(r) for r in rows)
    out = {"requests": len(rows), "tokens": tokens, "wall_s": walls,
           "tokens_per_s": [tokens / w for w in walls],
           "from_checkpoint_s": load_s, "engine_ms": engine_ms,
           "tokens_per_s_engine": [tokens * 1e3 / ms for ms in engine_ms],
           "direct_engine_tokens_per_s": direct_tokens_per_s,
           "fresh_direct_engine_tokens_per_s":
               sum(len(r.generated) for r in reqs) / fresh_s,
           "flash_launches": launches["flash_attention_fwd"],
           "flash_admissions": want // N_LAYERS,
           "subprocess_wall_s": sub_wall}
    log(f"[cli] predict (LM checkpoint) {json.dumps(out)}")
    return out


def _write_csv(path, n, seed) -> tuple:
    x, y = _mnist(n, seed)
    labels = y.argmax(-1)
    np.savetxt(path, np.concatenate([x, labels[:, None]], axis=1),
               fmt="%.4f", delimiter=",")
    return np.round(x, 4).astype(np.float32), labels


def cli_mlp(work, fit_ms_per_step) -> dict:
    """``train``/``test``/``predict`` of the MNIST MLP (zoo.mnist_mlp's
    conf JSON) on synthetic_mnist CSVs at batch 512, each with the launches
    counted from 0: K1 launches exactly 2 x the train steps and 2 x the
    batches of test and of predict; test's accuracy above 0.9; predict's
    classes equal net.predict of a net loaded from the same params.npz."""
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader,
        RecordReaderDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    t0 = time.perf_counter()
    _write_csv(f"{work}/train.csv", CLI_TRAIN_ROWS, seed=31)
    hx, hy = _write_csv(f"{work}/held.csv", CLI_HELD_OUT, seed=32)
    write_s = time.perf_counter() - t0
    conf = mnist_mlp(MLP_H1, MLP_H2)
    with open(f"{work}/mlp.json", "w") as f:
        f.write(conf.to_json())
    t0 = time.perf_counter()
    it = RecordReaderDataSetIterator(CSVRecordReader(f"{work}/train.csv"),
                                     MLP_BATCH, num_possible_labels=10)
    read_rows = sum(ds.num_examples() for ds in it)
    read_s = time.perf_counter() - t0
    assert read_rows == CLI_TRAIN_ROWS

    common = ["--conf", f"{work}/mlp.json", "--model", f"{work}/params.npz",
              "--batch", MLP_BATCH, "--labels", 10, "--device", DEVICE]
    steps = CLI_EPOCHS * -(-CLI_TRAIN_ROWS // MLP_BATCH)
    held_batches = -(-CLI_HELD_OUT // MLP_BATCH)
    launches = {}
    _kernels.reset_launches()
    _, train_s = _cli(["train", "--input", f"{work}/train.csv",
                          "--epochs", CLI_EPOCHS, *common])
    launches["train"] = _kernels.LAUNCHES["fused_dense"]
    _kernels.reset_launches()
    text, test_s = _cli(["test", "--input", f"{work}/held.csv", *common])
    launches["test"] = _kernels.LAUNCHES["fused_dense"]
    _kernels.reset_launches()
    _, predict_s = _cli(["predict", "--input", f"{work}/held.csv",
                            "--output", f"{work}/preds.txt", *common])
    launches["predict"] = _kernels.LAUNCHES["fused_dense"]
    want = {"train": 2 * steps, "test": 2 * held_batches,
            "predict": 2 * held_batches}
    if launches != want:
        raise AssertionError(f"cli MLP: fused_dense launches {launches}, "
                             f"expected {want}")
    accuracy = float(re.search(r"Accuracy:\s+([0-9.]+)", text).group(1))
    with open(f"{work}/preds.txt") as f:
        preds = np.array([int(t) for t in f.read().split()])
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.set_params(np.load(f"{work}/params.npz")["params"])
    direct = np.concatenate([net.predict(hx[i:i + MLP_BATCH])
                             for i in range(0, CLI_HELD_OUT, MLP_BATCH)])
    if not (accuracy > 0.9 and preds.shape == (CLI_HELD_OUT,)
            and np.array_equal(preds, direct)):
        raise AssertionError(f"cli MLP: test accuracy {accuracy}, predict "
                             f"equal to net.predict: "
                             f"{np.array_equal(preds, direct)}")
    out = {"train_rows": CLI_TRAIN_ROWS, "held_out": CLI_HELD_OUT,
           "epochs": CLI_EPOCHS, "steps": steps, "batch": MLP_BATCH,
           "csv_write_s": write_s, "csv_read_s": read_s,
           "train_wall_s": train_s, "ms_per_step": train_s * 1e3 / steps,
           "fit_epochs_ms_per_step": fit_ms_per_step,
           "test_wall_s": test_s, "predict_wall_s": predict_s,
           "test_accuracy": accuracy,
           "held_out_accuracy_of_predict": float((preds == hy).mean()),
           "launches": launches}
    log(f"[cli] MLP train/test/predict {json.dumps(out)}")
    return out


def cli(params, direct_tokens_per_s, fit_ms_per_step) -> dict:
    """Phase 8: the CLI, the port's user entry point, over the paths of
    phases 3 and 5."""
    import shutil
    import tempfile

    work = tempfile.mkdtemp(prefix="dl4j_torch_cli_")
    try:
        ckpt = ckpt_round_trip(params, work)
        lm = cli_predict_lm(params, ckpt["f32"]["root"], work,
                            direct_tokens_per_s)
        mlp_run = cli_mlp(work, fit_ms_per_step)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"ckpt": ckpt, "lm": lm, "mlp": mlp_run}


# ------------------------------------------------------------- phase 9 ----

# LeNet, BASELINE #2, at the bench's width (bench.py:53, :203,
# models/zoo.lenet): batch 512 of synthetic_mnist, 200-step chunks
LENET_BATCH, LENET_WARMUP, LENET_STEPS, LENET_CHUNK = 512, 2, 50, 200
# fit_epochs's learning check trains at lr 0.02. At the zoo's lr 0.05
# (momentum 0.9) the first steps overshoot (score 4.5 -> 7.5) and, for
# about 1 init in 12, kill most of layer 4's ReLUs: the net sits at chance
# (score ln 10) for good, on the card and on the CPU alike, and the JAX
# package follows the same trajectory from the same init. The port's
# default init at batch 512 is one of those (held-out accuracy 0.451 after
# 52 steps); at 0.02 all 12 inits tried reach 1.0. The timed chunks keep
# the zoo's conf (lr 0.05), whose speed does not depend on the rate
LENET_FIT_LR = 0.02
# conv_wide at the bench's width (bench.py:203-205, :259-266): batch 64 of
# (32, 32, 32) normal inputs, 32-step chunks
CONV_BATCH, CONV_CHUNK = 64, 32
# conv_wide's two convolutions, 5x5 VALID: (C, H=W, O) of each
CONV_LAYERS = ((32, 32, 128), (128, 14, 128))
# the two conv routes (cuDNN, unfold + one product) at f32 with TF32 off:
# max abs error over the reference's max |value| of outputs and grads;
# f32 sums over contractions of 800 and 3200 in different orders
CONV_ROUTE_TOL = 1e-4
# K1 at the slice's dense layers: LeNet's layers 4 and 5 (launches over
# the timed fit_epochs run) and conv_wide's layer 4 (over the f32 chunk)
CONV_DENSE_LAYERS = (
    ("lenet layer 4", LENET_BATCH, 256, 120,
     "LeNet's two dense layers over the timed fit_epochs run"),
    ("lenet layer 5", LENET_BATCH, 120, 84,
     "LeNet's two dense layers over the timed fit_epochs run"),
    ("conv_wide layer 4", CONV_BATCH, 3200, 256,
     "conv_wide's dense layer over the f32 chunk"))
# the SdA, BASELINE #3, at its defaults (784-500-250-10, corruption 0.3, 10
# iterations a batch): fit on 4096 synthetic_mnist rows at batch 512
SDA_ROWS, SDA_BATCH = 4096, 512
# CheckpointIterationListener on LeNet: saves every 50 iterations of a
# 60-iteration fit_epochs; the live state is held at iteration 50
CKPT_EVERY, CKPT_ITERS = 50, 60
def lenet_fit() -> dict:
    """The facade's main path for LeNet: MultiLayerNetwork(lenet(lr=
    LENET_FIT_LR)).fit_epochs over a ListDataSetIterator at batch 512,
    LENET_WARMUP
    warm-up steps then LENET_STEPS timed steps (K1 counted from 0 over
    exactly those: 2 a step, layers 4 and 5), then predict on HELD_OUT
    held-out examples (counted alone: 2)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    b, w = LENET_BATCH, LENET_WARMUP
    x, y = _mnist(b * (w + LENET_STEPS), seed=11)
    net = MultiLayerNetwork(lenet(lr=LENET_FIT_LR), device=DEVICE).init()
    net.fit_epochs(ListDataSetIterator(DataSet(x[:w * b], y[:w * b]), b))
    first = DataSet(x[w * b:(w + 1) * b], y[w * b:(w + 1) * b])
    score0 = net.score(first)
    timed = ListDataSetIterator(DataSet(x[w * b:], y[w * b:]), b)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(timed)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    score1 = net.score(first)
    if launches != 2 * LENET_STEPS:
        raise AssertionError(f"LeNet: fused_dense launched {launches} times "
                             f"over {LENET_STEPS} steps, expected 2 a step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"LeNet score on the first timed batch "
                             f"{score0} -> {score1}: not finite or not "
                             "falling")
    hx, hy = _mnist(HELD_OUT, seed=12)
    _kernels.reset_launches()
    pred = net.predict(hx)
    predict_launches = _kernels.LAUNCHES["fused_dense"]
    accuracy = float((pred == hy.argmax(-1)).mean())
    if predict_launches != 2 or not accuracy > 0.9:
        raise AssertionError(f"LeNet predict: {predict_launches} launches "
                             f"(expected 2), accuracy {accuracy}")
    ms = wall * 1e3 / LENET_STEPS
    out = {"steps": LENET_STEPS, "batch": b, "lr": LENET_FIT_LR,
           "tf32": False, "wall_s": wall,
           "ms_per_step": ms, "samples_per_s": b * 1e3 / ms,
           "score_first_batch": [score0, score1], "launches": launches,
           "predict_launches": predict_launches,
           "held_out_accuracy": accuracy}
    log(f"[lenet] fit_epochs {json.dumps(out)}")
    return out


def lenet_rates() -> dict:
    """Held-out accuracy of LeNet after 52 fit_epochs steps at batch 512
    from 12 inits (conf seeds 42-53), at the zoo's lr 0.05 and at
    LENET_FIT_LR: the evidence for the learning check's rate, logged,
    not checked."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    steps = LENET_WARMUP + LENET_STEPS
    x, y = _mnist(LENET_BATCH * steps, seed=11)
    hx, hy = _mnist(HELD_OUT, seed=12)
    out = {}
    for lr in (0.05, LENET_FIT_LR):
        accs = []
        for seed in range(42, 54):
            net = MultiLayerNetwork(lenet(lr=lr, seed=seed),
                                    device=DEVICE).init()
            net.fit_epochs(ListDataSetIterator(DataSet(x, y), LENET_BATCH))
            accs.append(float((net.predict(hx) == hy.argmax(-1)).mean()))
        out[f"lr {lr}"] = {"held_out_accuracy_by_seed": accs,
                           "inits_above_0.9": sum(a > 0.9 for a in accs)}
    log(f"[lenet] {steps} steps from 12 inits {json.dumps(out)}")
    return out


def lenet_chunks() -> list:
    """LeNet's 200-step chunks at f32 and bf16, and a profiled f32 one;
    K1 launches 2 a step in each."""
    import torch

    from deeplearning4j_tpu_torch.models.zoo import lenet

    x, y = _mnist(LENET_BATCH * LENET_CHUNK, seed=13)
    xs = torch.from_numpy(x).to(DEVICE).reshape(LENET_CHUNK, LENET_BATCH, -1)
    ys = torch.from_numpy(y).to(DEVICE).reshape(LENET_CHUNK, LENET_BATCH, -1)
    return [train_chunk("lenet", lenet(), xs, ys, 2 * LENET_CHUNK,
                        bf16=bf16, profiled=profiled)
            for bf16, profiled in ((False, False), (True, False),
                                   (False, True))]


def conv_routes() -> dict:
    """LeNet's two convolutions (batch 512) and conv_wide's two (batch 64)
    through both routes of ``conv2d`` (set_conv_emitter(True): cuDNN's
    convolution, its weight gradient one product over the patches; False:
    unfold + one product): device ms of the forward and of forward +
    backward (grads of x and w), f32 and bf16, TF32 off. At f32 each
    route's output and grads are held against a float64 reference
    (cuDNN's double convolution and its autograd), logged beside cuDNN's
    own f32 backward's, and the two routes against each other within
    CONV_ROUTE_TOL."""
    import torch
    import torch.nn.functional as tf

    from deeplearning4j_tpu_torch.nn.layers import convolution as conv

    layers = [("lenet layer 0", LENET_BATCH, 1, 28, 6),
              ("lenet layer 2", LENET_BATCH, 6, 12, 16)]
    layers += [(f"conv_wide layer {i}", CONV_BATCH, c, h, o)
               for i, (c, h, o) in zip((0, 2), CONV_LAYERS)]
    out = {}
    for seed, (name, b, c, h, o) in enumerate(layers):
        gen = torch.Generator(device=DEVICE).manual_seed(50 + seed)
        x = torch.randn((b, c, h, h), generator=gen, device=DEVICE)
        w = torch.randn((o, c, 5, 5), generator=gen,
                        device=DEVICE) / (25 * c) ** 0.5
        r = torch.randn((b, o, h - 4, h - 4), generator=gen, device=DEVICE)
        x64, w64 = (t.double().requires_grad_() for t in (x, w))
        y64 = tf.conv2d(x64, w64)
        ref = (y64.detach(), *torch.autograd.grad(y64, (x64, w64),
                                                  r.double()))
        row = {"shape": f"x ({b},{c},{h},{h}) w ({o},{c},5,5)",
               "gflop_fwd": 2.0 * b * o * (h - 4) ** 2 * c * 25 / 1e9}
        f32_out = {}
        for dtype in (torch.float32, torch.bfloat16):
            xd, wd, rd = (t.to(dtype) for t in (x, w, r))
            xg, wg = (t.clone().requires_grad_() for t in (xd, wd))
            for route in (True, False):
                conv.set_conv_emitter(route)
                try:
                    fwd = device_ms(lambda: conv.conv2d(xd, wd))
                    both = device_ms(lambda: torch.autograd.grad(
                        conv.conv2d(xg, wg), (xg, wg), rd))
                    y = conv.conv2d(xg, wg)
                    grads = torch.autograd.grad(y, (xg, wg), rd)
                finally:
                    conv.set_conv_emitter(None)
                key = f"{'conv' if route else 'im2col'} {str(dtype)[6:]}"
                row[key] = {"fwd_ms": fwd, "fwd_bwd_ms": both}
                if dtype == torch.float32:
                    f32_out[route] = (y.detach(), *grads)
                    row[key]["rel_err_vs_f64"] = [
                        _rel_err(a.double(), want)
                        for a, want in zip(f32_out[route], ref)]
        # cuDNN's own backward (torch's autograd of conv2d), which the conv
        # route does not use for dW
        xg, wg = (t.clone().requires_grad_() for t in (x, w))
        y = tf.conv2d(xg, wg)
        lib = (y.detach(), *torch.autograd.grad(y, (xg, wg), r))
        row["cudnn autograd float32"] = {"rel_err_vs_f64": [
            _rel_err(a.double(), want) for a, want in zip(lib, ref)]}
        errs = [_rel_err(a, want) for a, want in zip(f32_out[True],
                                                    f32_out[False])]
        row["f32_routes_rel_err"] = errs
        out[name] = row
        if max(errs) > CONV_ROUTE_TOL:
            raise AssertionError(f"{name}: the conv routes disagree at f32: "
                                 f"out, dx, dw rel err {errs} (tol "
                                 f"{CONV_ROUTE_TOL}); against float64 "
                                 f"{json.dumps(row)}")
    log(f"[conv] routes, TF32 off {json.dumps(out)}")
    return out


def conv_wide_chunks() -> list:
    """conv_wide's 32-step chunks at batch 64 on (32, 32, 32) normal inputs:
    f32 and bf16 with TF32 off, f32 with cuDNN's TF32 default on, and
    profiled f32 and bf16 chunks; K1 launches once a step (layer 4)."""
    import torch

    from deeplearning4j_tpu_torch.models.zoo import conv_wide

    gen = torch.Generator(device=DEVICE).manual_seed(2)
    xs = torch.randn((CONV_CHUNK, CONV_BATCH, 32, 32, 32), generator=gen,
                     device=DEVICE)
    labels = torch.randint(0, 10, (CONV_CHUNK, CONV_BATCH), generator=gen,
                           device=DEVICE)
    ys = torch.nn.functional.one_hot(labels, 10).float()
    return [train_chunk("conv_wide", conv_wide(), xs, ys, CONV_CHUNK,
                        bf16=bf16, tf32=tf32, profiled=profiled)
            for bf16, tf32, profiled in ((False, False, False),
                                         (True, False, False),
                                         (False, True, False),
                                         (False, False, True),
                                         (True, False, True))]


def _sda_phase(model) -> str:
    """Which phase of the SdA's fit called a listener: a pretraining
    solver (named by its layer's n_in), the head's finetuning solver, or
    backprop (the network itself)."""
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    if isinstance(model, MultiLayerNetwork):
        return "backprop"
    if model.conf.layer_type.value == "OUTPUT":
        return "finetune"
    return f"pretrain {model.conf.n_in}-{model.conf.n_out}"


def sda_fit() -> tuple:
    """The SdA at its defaults driven by ``fit`` (pretrain → finetune →
    backprop) on SDA_ROWS rows at batch SDA_BATCH. K1 never launches (the
    AE layers and the head are plain products). Each pretrained layer's
    score and the finetune score fall from their first solver's first
    iteration to their last solver's last. Wall time per phase, from
    listener timestamps. Returns (summary, net, one batch)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import (
        stacked_denoising_autoencoder,
    )
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    x, y = _mnist(SDA_ROWS, seed=15)
    net = MultiLayerNetwork(stacked_denoising_autoencoder(),
                            device=DEVICE).init()
    calls = []
    net.set_listeners([lambda model, it, score: calls.append(
        (_sda_phase(model), it, score, time.perf_counter()))])
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit(ListDataSetIterator(DataSet(x, y), SDA_BATCH))
    sync()
    t_end = time.perf_counter()
    launches = _kernels.LAUNCHES["fused_dense"]
    phases = {}
    for phase, _, score, t in calls:
        p = phases.setdefault(phase, {"calls": 0, "scores": []})
        p["calls"] += 1
        p["scores"].append(score)
        p["last_t"] = t
    order = list(phases)
    start = t0
    for phase in order:
        p = phases[phase]
        end = t_end if phase == order[-1] else p["last_t"]
        p["wall_s"] = end - start
        start = end
        p["first_last_score"] = [p["scores"][0], p["scores"][-1]]
        del p["scores"], p["last_t"]
    calls_a_phase = (SDA_ROWS // SDA_BATCH) * net.conf.conf(0).num_iterations
    want = {f"pretrain {c.n_in}-{c.n_out}": calls_a_phase
            for c in net.conf.confs[:-1]}
    want.update(finetune=calls_a_phase, backprop=calls_a_phase)
    got = {k: v["calls"] for k, v in phases.items()}
    falling = all(p["first_last_score"][1] < p["first_last_score"][0]
                  for k, p in phases.items() if k != "backprop")
    out = {"rows": SDA_ROWS, "batch": SDA_BATCH, "wall_s": t_end - t0,
           "phases": phases, "fused_dense_launches": launches}
    log(f"[sda] fit {json.dumps(out)}")
    if launches != 0 or got != want or order != list(want) or not falling:
        raise AssertionError(f"SdA fit: K1 launches {launches} (expected 0), "
                             f"listener calls {got} (expected {want}), "
                             f"scores falling {falling}")
    return out, net, (x[:SDA_BATCH], y[:SDA_BATCH])


def solvers_on_card(net, batch) -> dict:
    """The SdA head finetuned once each by CONJUGATE_GRADIENT, LBFGS and
    HESSIAN_FREE over one batch's top-of-stack activations of the fitted
    net, each from a fresh init of the head (what finetune starts from
    after pretraining; the fitted head's score is already ~1e-8): the
    score falls and the params stay finite."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.nn.api import OptimizationAlgorithm
    from deeplearning4j_tpu_torch.nn.layers import output as output_ops
    from deeplearning4j_tpu_torch.nn.params import init_layer_params
    from deeplearning4j_tpu_torch.optimize.solver import Solver

    head_idx = net.conf.n_layers - 1
    head = init_layer_params(7, net.conf.conf(head_idx), device=DEVICE)
    x, y = (torch.from_numpy(a).to(DEVICE) for a in batch)
    with torch.no_grad():
        top = F.hidden_activation(net.conf, net.params_tree, x, head_idx)
    out = {}
    for algo in ("CONJUGATE_GRADIENT", "LBFGS", "HESSIAN_FREE"):
        conf = dataclasses.replace(
            net.conf.conf(head_idx),
            optimization_algo=OptimizationAlgorithm[algo])
        solver = Solver(conf, lambda p, key: output_ops.output_loss(
            conf, p, top, y))
        t0 = time.perf_counter()
        params = solver.optimize(head, 1)
        sync()
        hist = solver.score_history
        finite = all(torch.isfinite(p).all().item()
                     for p in tree_leaves(params))
        out[algo] = {"iterations": len(hist), "first_last_score":
                     [hist[0], hist[-1]],
                     "wall_s": time.perf_counter() - t0}
        if not (finite and hist[-1] < hist[0]):
            raise AssertionError(f"{algo} on the SdA head: scores {hist}, "
                                 f"finite params {finite}")
    log(f"[solvers] SdA head {json.dumps(out)}")
    return out


def ckpt_listener() -> dict:
    """LeNet's fit_epochs with CheckpointIterationListener saving every
    CKPT_EVERY iterations and a listener holding clones of the live
    params, updater state and key at iteration CKPT_EVERY; restore_net of
    that step gives them back, torch.equal, on the card."""
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import lenet
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.ckpt import (
        Checkpointer,
        CheckpointIterationListener,
    )
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    root = tempfile.mkdtemp(prefix="dl4j_torch_netstate_")
    try:
        reg = MetricsRegistry()
        ck = Checkpointer(root, registry=reg)
        net = MultiLayerNetwork(lenet(), device=DEVICE).init()
        held = {}

        def hold(model, iteration, score):
            if iteration == CKPT_EVERY:
                held["params"] = [p.clone() for p in
                                  tree_leaves(model.params_tree)]
                held["state"] = [s.clone() for s in
                                 tree_leaves(model._train_state)]
                held["key"] = model._keys._key

        listener = CheckpointIterationListener(ck, save_every=CKPT_EVERY)
        net.set_listeners([listener, hold])
        x, y = _mnist(LENET_BATCH * CKPT_ITERS // 2, seed=16)
        net.fit_epochs(ListDataSetIterator(DataSet(x, y), LENET_BATCH),
                       num_epochs=2)
        t0 = time.perf_counter()
        back, it = ck.restore_net(step=CKPT_EVERY, device=DEVICE)
        restore_s = time.perf_counter() - t0
        params = tree_leaves(back.params_tree)
        state = tree_leaves(back._train_state)
        equal = (it == CKPT_EVERY and back._keys._key == held["key"]
                 and len(params) == len(held["params"])
                 and len(state) == len(held["state"])
                 and all(torch.equal(a, b) for a, b in
                         zip(params + state, held["params"] + held["state"])))
        snap = reg.snapshot()
        save_ms = [h for h in snap["histograms"]
                   if h["name"] == "ckpt_save_ms"][0]
        out = {"iterations": net._iteration, "saved_steps":
               listener.saved_steps, "restored_iteration": it,
               "equal": equal, "save_ms_mean": save_ms["sum"]
               / max(save_ms["count"], 1), "restore_s": restore_s,
               "device": str(params[0].device)}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"[ckpt] CheckpointIterationListener + restore_net "
        f"{json.dumps(out)}")
    if not (equal and listener.saved_steps == [CKPT_EVERY]
            and params[0].device.type == DEVICE):
        raise AssertionError(f"net-state round trip on the card: {out}")
    return out


def slice5() -> list:
    """Phase 9; returns K1's entries of the kernels line at the slice's
    dense shapes."""
    from deeplearning4j_tpu_torch.models.zoo import lenet

    dense_parity(tuple(((m, k, n), 0) for _, m, k, n, _ in
                       CONV_DENSE_LAYERS))
    entries = dense_measure(CONV_DENSE_LAYERS)
    main_run = lenet_fit()
    lenet_rates()
    chunks = lenet_chunks()
    k1_grad_parity("LeNet", lenet(), LENET_BATCH, 14)
    routes = conv_routes()
    # LeNet's convolutions (the gate's im2col route, f32, forward +
    # backward) against a profiled step's device time
    conv_ms = sum(routes[f"lenet layer {i}"]["im2col float32"]["fwd_bwd_ms"]
                  for i in (0, 2))
    step_ms = max(chunks[2]["device_busy_ms"] / chunks[2]["steps"], 1e-9)
    log(f"[lenet] convolutions alone {conv_ms:.4f} ms of a step's "
        f"{step_ms:.4f} ms of device time: {conv_ms / step_ms:.3f}")
    wide = conv_wide_chunks()
    for entry in entries:
        if entry["shape"].startswith("lenet"):
            entry["launches"] = main_run["launches"]
        else:
            entry["launches"] = wide[0]["launches"]
        if "bfloat16" in entry["shape"]:
            entry["launches_cover"] += " (f32, the path's type)"
    _, net, batch = sda_fit()
    solvers_on_card(net, batch)
    ckpt_listener()
    return entries


# ------------------------------------------------------------ phase 10 ----

# word2vec at bench.py's two scales (measure_word2vec, bench.py:529-558,
# :3061-3067): the zipf corpus of numpy seed 0, window 5, negative 5,
# sample 1e-3, one iteration, seed 1; words/s is corpus words over the
# fenced wall time of one warm fit
W2V_LARGE = dict(n_sentences=20_000, sent_len=100, vocab=50_000,
                 layer_size=256, batch_size=65_536)
W2V_TOY = dict(n_sentences=2_000, sent_len=100, vocab=5_000,
               layer_size=100, batch_size=8_192)
# one SGNS (shared and per-pair) and one HS epoch on the card against the
# port's CPU run from the same draws: max abs difference of every table
# (values of a few tenths), and pair counts exactly. Both sides sum in f32
# in other orders (the card's index_add_ with atomics)
W2V_CARD_TOL = 1e-5
# NativeCSVDataSetIterator feeding the MNIST MLP: CSV rows, batch
NATIVE_CSV_ROWS, NATIVE_CSV_BATCH = 2048, 512
NATIVE_BUILD = {}   # the native library's build, filled by build_kernels


def _w2v_corpus(n_sentences, sent_len, vocab, **_) -> list:
    """bench.py's word2vec corpus: zipf-ish word ids, numpy seed 0."""
    rng = np.random.default_rng(0)
    words = np.array([f"w{i}" for i in range(vocab)])
    probs = 1.0 / np.arange(1, vocab + 1)
    probs /= probs.sum()
    ids = rng.choice(vocab, (n_sentences, sent_len), p=probs)
    return [" ".join(row) for row in words[ids]]


def _topic_corpus(n: int) -> list:
    """The tests' two-topic corpus (fruit and machine words)."""
    fruit = "apple banana cherry fruit sweet juice"
    tech = "cpu gpu chip silicon compute memory"
    rng = np.random.default_rng(0)
    sents = []
    for _ in range(n):
        sents.append(" ".join(rng.permutation(fruit.split()).tolist()))
        sents.append(" ".join(rng.permutation(tech.split()).tolist()))
    return sents


def _w2v(sents, device=None, **kw):
    from deeplearning4j_tpu_torch.models.word2vec import Word2Vec
    from deeplearning4j_tpu_torch.text.sentence_iterator import (
        CollectionSentenceIterator,
    )

    opts = dict(window=5, negative=5, iterations=1, sample=1e-3, seed=1)
    opts.update(kw)
    return Word2Vec(sentence_iterator=CollectionSentenceIterator(sents),
                    device=device or DEVICE, **opts)


def w2v_vocab(sents, smi: str) -> dict:
    """build_vocab on the word2vec_large corpus through the native path
    (asserted by its call count) and through the Python path: wall time of
    each, and equal vocab and index arrays."""
    from deeplearning4j_tpu_torch.native import lib as nlib

    runs = {}
    for path in ("native", "python"):
        vec = _w2v(sents, layer_size=8)
        if path == "python":
            vec._native_path_possible = lambda: False
        nlib.reset_calls()
        t0 = time.perf_counter()
        vec.build_vocab()
        runs[path] = (vec, time.perf_counter() - t0,
                      nlib.CALLS["corpus_index"])
    (nat, nat_s, nat_calls), (py, py_s, py_calls) = runs["native"], \
        runs["python"]
    if (nat_calls, py_calls) != (1, 0):
        raise AssertionError(f"corpus_index calls: native path {nat_calls}, "
                             f"python path {py_calls}; expected 1 and 0")
    same = ([(w.word, w.count) for w in nat.vocab.words()]
            == [(w.word, w.count) for w in py.vocab.words()]
            and np.array_equal(nat._flat, py._flat)
            and np.array_equal(nat._sid, py._sid))
    if not same:
        raise AssertionError("native and python vocab paths disagree")
    out = {"words": len(sents) * len(sents[0].split()),
           "vocab": nat.vocab.num_words(), "native_s": nat_s,
           "python_s": py_s, "python_over_native": py_s / nat_s,
           "native_corpus_index_calls": nat_calls, "card": smi}
    log(f"[w2v] build_vocab {json.dumps(out)}")
    return out


def w2v_fit(name, sents, smi, profiled=True, **kw) -> dict:
    """A warm fit, then one fit timed to the fence (block_until_ready):
    words/s and last_fit_timings; with ``profiled`` one more fit under
    torch.profiler for the busy share and the device operations a step."""
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.models.word2vec import neg_group_size

    vec = _w2v(sents, **kw)
    vec.build_vocab()
    vec.fit()
    vec.block_until_ready()
    sync()
    t0 = time.perf_counter()
    vec.fit()
    vec.block_until_ready()
    wall = time.perf_counter() - t0
    words = sum(len(s.split()) for s in sents)
    block = max(-(-vec.batch_size // (2 * vec.window)), 1)
    n_steps = -(-int(vec._flat.size) // block)
    bsz = block * 2 * vec.window
    out = {"run": name, "words": words, "vocab": vec.vocab.num_words(),
           "layer_size": vec.layer_size, "batch_pairs": bsz,
           "neg_group": (neg_group_size(bsz, vec.shared_negatives)
                         if vec.shared_negatives and vec.negative else 0),
           "hs": vec.use_hs, "steps_per_epoch": n_steps, "wall_s": wall,
           "words_per_s": words / wall, "ms_per_step": wall * 1e3 / n_steps,
           "last_fit_timings": vec.last_fit_timings, "card": smi}
    table = vec.lookup_table
    if not np.isfinite(table.syn0).all() or vec.total_words_trained <= 0:
        raise AssertionError(f"{name}: non-finite table or no pairs trained")
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vec.fit()
            vec.block_until_ready()
            pwall = time.perf_counter() - t0
        busy = device_busy(prof, pwall)
        counts = _by_name(prof, lambda e: e.count)
        out["profiled"] = {
            "busy_share": busy["busy_share"],
            "device_busy_ms": busy["device_busy_ms"],
            "wall_ms": busy["wall_ms"],
            "device_ops_per_step": sum(counts.values()) / n_steps,
            "top_device_ms": busy["top_kernels_ms"],
            "top_device_ops_per_step": {
                k: n / n_steps for k, n in list(counts.items())[:8]}}
    log(f"[w2v] fit {json.dumps(out)}")
    return out


def _cpu_draws(w2v):
    """Make ``w2v``'s draw points draw on the CPU and move the draws to
    the tensor's device: the card and the CPU then draw the same numbers
    from a key. Returns the originals, to put back."""
    orig = (w2v._keep_uniforms, w2v._window_draws, w2v._neg_slots)
    w2v._keep_uniforms = lambda k, n, d: orig[0](k, n, "cpu").to(d)
    w2v._window_draws = lambda k, n, win, d: orig[1](k, n, win, "cpu").to(d)
    w2v._neg_slots = lambda k, s, slots, d: orig[2](k, s, slots, "cpu").to(d)
    return orig


def w2v_card_parity() -> dict:
    """One SGNS epoch (shared and per-pair negatives) and one HS epoch of
    the device functions on the card and on the CPU, the draws made on the
    CPU and moved to the card: every table within W2V_CARD_TOL, pair counts
    equal."""
    import torch

    from deeplearning4j_tpu_torch.models import word2vec as w2v

    vec = _w2v(_w2v_corpus(60, 50, 300), device="cpu", layer_size=32,
               batch_size=256, use_hierarchic_softmax=True, sample=1e-2)
    vec.build_vocab()
    flat, sid = (torch.from_numpy(a.astype(np.int64))
                 for a in (vec._flat, vec._sid))
    keep = torch.from_numpy(vec._keep_probs().astype(np.float32))
    table = vec.lookup_table
    syn0 = torch.from_numpy(np.array(table.syn0))
    rng = np.random.default_rng(5)
    syn1 = torch.from_numpy(
        (rng.normal(size=table.syn1.shape) * 0.1).astype(np.float32))
    syn1neg = torch.from_numpy(
        (rng.normal(size=table.syn1neg.shape) * 0.1).astype(np.float32))
    neg_table = w2v.build_neg_table(table.unigram_probs(), device="cpu")
    hs = [t.cpu() for t in vec._huffman_tables()]
    window, block = vec.window, 64
    n_steps = -(-flat.numel() // block)
    lrs = torch.linspace(0.05, 0.01, n_steps)
    orig = _cpu_draws(w2v)

    def on(dev, tensors):
        return [t.to(dev).clone() for t in tensors]

    out = {}
    try:
        for run in ("sgns shared", "sgns per-pair", "hs"):
            res = {}
            for dev in ("cpu", DEVICE):
                if run == "hs":
                    a = on(dev, [syn0, syn1, flat, sid, keep, *hs, lrs])
                    res[dev] = w2v._hs_device_epoch(
                        *a, 7, window=window, block=block, n_steps=n_steps)
                else:
                    a = on(dev, [syn0, syn1neg, flat, sid, keep, neg_table,
                                 lrs])
                    res[dev] = w2v._sgns_device_epoch(
                        *a, 7, window=window, negative=5, block=block,
                        n_steps=n_steps,
                        neg_group=8 if run == "sgns shared" else 0)
            cpu, card = res["cpu"], res[DEVICE]
            errs = [float((c.cpu() - h).abs().max())
                    for c, h in zip(card[:2], cpu[:2])]
            pairs = (float(card[3]), float(cpu[3]))
            out[run] = {"max_abs_err": errs, "pairs": pairs[1],
                        "moved": float((cpu[0] - syn0).abs().max())}
            if max(errs) > W2V_CARD_TOL or pairs[0] != pairs[1] \
                    or out[run]["moved"] == 0:
                raise AssertionError(f"word2vec {run} epoch: card against "
                                     f"CPU {out[run]}, card pairs "
                                     f"{pairs[0]}")
    finally:
        w2v._keep_uniforms, w2v._window_draws, w2v._neg_slots = orig
    log(f"[parity] word2vec epochs, card against CPU: {json.dumps(out)}")
    return out


def nlp_learning() -> dict:
    """The tests' learning checks on the card: Word2Vec (shared and
    per-pair SGNS, HS) separates the two topics, GloVe and
    ParagraphVectors too."""
    from deeplearning4j_tpu_torch.models import Glove, ParagraphVectors
    from deeplearning4j_tpu_torch.text.sentence_iterator import (
        CollectionSentenceIterator,
    )

    tech = {"gpu", "chip", "silicon", "compute", "memory"}
    out = {}
    for run, kw in (("sgns shared", dict(lr=0.05)),
                    ("sgns per-pair", dict(lr=0.1, shared_negatives=0)),
                    ("hs", dict(lr=0.1, negative=0,
                                use_hierarchic_softmax=True))):
        vec = _w2v(_topic_corpus(200), layer_size=16, window=3,
                   iterations=10, sample=0, batch_size=128, **kw)
        vec.fit()
        near = vec.words_nearest("cpu", 5)
        pair = (("banana", "cherry"), ("banana", "chip")) if run == "hs" \
            else (("apple", "banana"), ("apple", "gpu"))
        same, cross = (vec.similarity(*pair[0]), vec.similarity(*pair[1]))
        out[run] = {"same": same, "cross": cross, "nearest_cpu": near}
        # the checks of tests/test_torch_word2vec.py for each objective
        ok = same > cross and (run != "sgns shared"
                               or len(tech & set(near)) >= 3)
        if not ok:
            raise AssertionError(f"word2vec {run} did not learn the "
                                 f"topics: {out[run]}")
    glove = Glove(sentence_iterator=CollectionSentenceIterator(
        _topic_corpus(150)), layer_size=16, window=5, lr=0.1,
        iterations=25, x_max=10.0, seed=2, device=DEVICE)
    glove.fit()
    near = glove.words_nearest("cpu", 5)
    out["glove"] = {"loss": [glove.losses[0], glove.losses[-1]],
                    "same": glove.similarity("apple", "banana"),
                    "cross": glove.similarity("apple", "gpu"),
                    "nearest_cpu": near}
    if not (glove.losses[-1] < glove.losses[0]
            and out["glove"]["same"] > out["glove"]["cross"]
            and len(tech & set(near)) >= 3):
        raise AssertionError(f"GloVe did not learn: {out['glove']}")
    docs = ([(f"fruit_{i}", "apple banana cherry sweet juice fruit banana "
              "apple juice") for i in range(10)]
            + [(f"tech_{i}", "cpu gpu chip silicon compute memory gpu cpu "
                "compute") for i in range(10)])
    pv = ParagraphVectors(documents=docs, layer_size=16, window=3,
                          negative=5, iterations=30, lr=0.25, sample=0,
                          batch_size=128, seed=3, min_word_frequency=1,
                          device=DEVICE)
    pv.fit()
    near = pv.nearest_docs("tech_0", 5)
    out["paragraph_vectors"] = {
        "same": pv.similarity_docs("fruit_0", "fruit_1"),
        "cross": pv.similarity_docs("fruit_0", "tech_0"),
        "nearest_tech_0": near}
    if not (out["paragraph_vectors"]["same"]
            > out["paragraph_vectors"]["cross"]
            and sum(lab.startswith("tech_") for lab in near) >= 4):
        raise AssertionError(f"ParagraphVectors did not learn: "
                             f"{out['paragraph_vectors']}")
    log(f"[nlp] learning checks {json.dumps(out)}")
    return out


def w2v_serializers(vec, work) -> dict:
    """The trained table through the text and the binary word2vec format
    and back: same words in order, vectors within 1e-6 through the text
    format (6 decimals, then f32) and equal through the binary one."""
    from deeplearning4j_tpu_torch.models import embeddings as emb

    table = vec.lookup_table
    out = {}
    for kind, write, load, tol in (
            ("text", emb.write_word_vectors, emb.load_word_vectors, 1e-6),
            ("binary", emb.write_word_vectors_binary,
             emb.load_word_vectors_binary, 0.0)):
        path = f"{work}/vectors.{kind}"
        t0 = time.perf_counter()
        write(table, path)
        vocab, mat = load(path)
        err = float(np.abs(mat - table.syn0).max())
        out[kind] = {"s": time.perf_counter() - t0, "max_abs_err": err,
                     "rows": mat.shape[0]}
        if ([w.word for w in vocab.words()]
                != [w.word for w in vec.vocab.words()] or err > tol):
            raise AssertionError(f"{kind} serializer round trip: {out}")
    log(f"[w2v] serializers {json.dumps(out)}")
    return out


def native_csv_mlp(work) -> dict:
    """NativeCSVDataSetIterator over a CSV of synthetic_mnist feeding
    MultiLayerNetwork.fit_epochs of the MNIST MLP: the loader is native,
    K1 launches exactly 2 a step, the score falls."""
    from deeplearning4j_tpu_torch.datasets.async_iterator import (
        NativeCSVDataSetIterator,
    )
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.native import lib as nlib
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels

    path = f"{work}/mnist.csv"
    x, labels = _write_csv(path, NATIVE_CSV_ROWS, seed=21)
    it = NativeCSVDataSetIterator(path, NATIVE_CSV_BATCH,
                                  num_possible_labels=10)
    steps = -(-NATIVE_CSV_ROWS // NATIVE_CSV_BATCH)
    net = MultiLayerNetwork(mnist_mlp(MLP_H1, MLP_H2), device=DEVICE).init()
    probe = DataSet(x[:NATIVE_CSV_BATCH],
                    np.eye(10, dtype=np.float32)[labels[:NATIVE_CSV_BATCH]])
    score0 = net.score(probe)
    nlib.reset_calls()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    net.fit_epochs(it, num_epochs=2)
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    score1 = net.score(probe)
    out = {"rows": NATIVE_CSV_ROWS, "batch": NATIVE_CSV_BATCH,
           "steps": 2 * steps, "native": it.native,
           "loader_batches": nlib.CALLS["loader_batch"],
           "launches": launches, "wall_s": wall,
           "score": [score0, score1]}
    it.close()
    if not out["native"] or out["loader_batches"] != 2 * steps:
        raise AssertionError(f"native CSV iterator did not run: {out}")
    if launches != 2 * 2 * steps:
        raise AssertionError(f"fused_dense launched {launches} times over "
                             f"{2 * steps} steps, expected 2 per step")
    if not (np.isfinite([score0, score1]).all() and score1 < score0):
        raise AssertionError(f"native CSV MLP score not falling: {out}")
    log(f"[native] csv iterator -> MLP {json.dumps(out)}")
    return out


def slice6(smi: str) -> dict:
    """Phase 10: the text pipeline, the native library and the embedding
    models (Word2Vec SGNS and HS, GloVe, ParagraphVectors) on the card.
    No kernel of the port runs here; K1 runs in the CSV iterator's MLP."""
    import shutil
    import tempfile

    log(f"[native] library {json.dumps(NATIVE_BUILD)}")
    work = tempfile.mkdtemp(prefix="dl4j_torch_nlp_")
    try:
        large = _w2v_corpus(**W2V_LARGE)
        out = {"vocab": w2v_vocab(large, smi)}
        out["large"] = w2v_fit("word2vec_large", large, smi,
                               layer_size=W2V_LARGE["layer_size"],
                               batch_size=W2V_LARGE["batch_size"])
        del large
        toy = _w2v_corpus(**W2V_TOY)
        kw = dict(layer_size=W2V_TOY["layer_size"],
                  batch_size=W2V_TOY["batch_size"])
        out["toy"] = w2v_fit("word2vec", toy, smi, **kw)
        out["toy_per_pair"] = w2v_fit("word2vec per-pair", toy, smi,
                                      profiled=False, shared_negatives=0,
                                      **kw)
        out["toy_hs"] = w2v_fit("word2vec hs", toy, smi, profiled=False,
                                negative=0, use_hierarchic_softmax=True,
                                **kw)
        out["card_parity"] = w2v_card_parity()
        out["learning"] = nlp_learning()
        vec = _w2v(toy, **kw)
        vec.fit()
        out["serializers"] = w2v_serializers(vec, work)
        out["native_csv"] = native_csv_mlp(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {k: out[k]["words_per_s"] for k in
               ("large", "toy", "toy_per_pair", "toy_hs")}
    log(f"[w2v] words/s {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------------------ phase 11 ----

# the RNTN at Socher's width (models/rntn.py defaults): 512 trees from
# TreeVectorizer over seed-drawn sentences of 8-40 words for the card
# against the CPU and a small fit; the timed fit at the size of SST's
# training split (8,544 sentences, Socher et al. 2013), lengths drawn
# around SST-1's mean of 18 words (Kim 2014, Table 1), spread chosen here,
# clipped to 2-56 words. The vocabulary stays this script's ~100 words
# (SST's is ~17.8k): it sizes the embedding table, not the merge loop.
RNTN_TREES, RNTN_MIN_WORDS, RNTN_MAX_WORDS = 512, 8, 40
SST_TREES, SST_MEAN_WORDS, SST_SD_WORDS = 8544, 18, 8
SST_MIN_WORDS, SST_MAX_WORDS = 2, 56
RNTN_HIDDEN, RNTN_CLASSES, RNTN_ITERATIONS = 25, 5, 3
# each bucket step of the first iteration, the card's against the CPU's
# from the same state, params and AdaGrad history within this share of each
# leaf's max: on the CPU an f32 step of this corpus is up to 1.2e-3 of a
# leaf's max off a float64 step (V, the 64-merge bucket: a merge chain
# 64 tanh deep, and AdaGrad divides by sqrt(h + 1e-8) where h is small),
# so two f32 devices agree no closer. Over a whole iteration the
# trajectory is chaotic (f32 against float64 parts by up to 93% of a
# leaf's max on the CPU), so steps are held from a shared state.
RNTN_STEP_TOL = 5e-3
RNTN_LOSS_TOL = 1e-5  # a bucket step's loss, relative
# the MNIST MLP through ParameterAveragingTrainer in a one-rank NCCL group
TRAINER_WARMUP, TRAINER_STEPS = 2, 100
TRAINER_TOL = 1e-5  # against fit_epochs on the same batches, of each leaf's max
ZERO_TOL = 1e-6  # Adam sharded against replicated: the same math

_RNTN_VOCAB = (
    ("the", "a", "this", "that", "every", "some"),
    ("movie", "film", "plot", "cast", "story", "acting", "scene", "script",
     "ending", "director", "music", "actor", "camera", "dialogue", "house",
     "river", "night", "city", "friend", "character", "performance", "show"),
    ("is", "was", "seems", "feels", "looks", "became", "remains", "loved",
     "hated", "liked", "enjoyed", "watched", "made", "told", "showed"),
    ("very", "really", "quite", "quickly", "slowly", "truly", "rather"),
    ("and", "but", "with", "of", "in", "about", "for", "on", "not", "never"),
    ("excellent", "outstanding", "superb", "brilliant", "amazing",
     "wonderful", "beautiful", "great", "good", "nice", "enjoyable",
     "charming", "clever", "fine", "decent", "okay", "slow", "predictable",
     "mediocre", "bland", "bad", "poor", "boring", "dull", "weak", "silly",
     "terrible", "awful", "horrible", "dreadful", "painful", "old", "long",
     "new", "young", "dark"),
)
# determiners, nouns, verbs, adverbs, function words, adjectives
_RNTN_WEIGHTS = (0.18, 0.24, 0.14, 0.08, 0.14, 0.22)


def _rntn_sentences(n: int, seed: int, sst: bool = False) -> str:
    """``n`` sentences drawn from _RNTN_VOCAB's classes (numpy seed), each
    ending in " .": RNTN_MIN_WORDS to RNTN_MAX_WORDS words, uniform, or
    with ``sst`` SST-like lengths (SST_MEAN_WORDS, clipped)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if sst:
            k = int(np.clip(np.rint(rng.normal(SST_MEAN_WORDS,
                                               SST_SD_WORDS)),
                            SST_MIN_WORDS, SST_MAX_WORDS))
        else:
            k = int(rng.integers(RNTN_MIN_WORDS, RNTN_MAX_WORDS + 1))
        groups = rng.choice(len(_RNTN_VOCAB), size=k, p=_RNTN_WEIGHTS)
        out.append(" ".join(
            _RNTN_VOCAB[g][int(rng.integers(len(_RNTN_VOCAB[g])))]
            for g in groups) + " .")
    return " ".join(out)


def _rntn_tensors(bucket, device):
    import torch

    leaf, mrg, mmask, lbls, smask = bucket
    return (torch.from_numpy(leaf).long().to(device),
            torch.from_numpy(mrg).long().to(device),
            torch.from_numpy(mmask).to(device),
            torch.from_numpy(lbls).to(device),
            torch.from_numpy(smask).to(device))


def _leaf_rel_errs(got: dict, want: dict) -> dict:
    return {k: float((got[k].cpu() - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30))
            for k in want}


def rntn_card_parity(trees) -> dict:
    """Every bucket step of the first iteration on the card against the
    same step on the CPU from the card's state before it: params and
    AdaGrad history within RNTN_STEP_TOL of each leaf's max, the loss
    within RNTN_LOSS_TOL."""
    from deeplearning4j_tpu_torch.interop import rntn_params_from_numpy
    from deeplearning4j_tpu_torch.models import rntn as R

    model = R.RNTN(num_hidden=RNTN_HIDDEN, num_classes=RNTN_CLASSES,
                   seed=0, device=DEVICE)
    model._build_vocab(trees)
    params = rntn_params_from_numpy(model._init_params(), DEVICE)
    hist = {k: v.new_zeros(v.shape) for k, v in params.items()}
    steps = []
    for bucket in model._prepare(trees):
        host_p = {k: v.cpu() for k, v in params.items()}
        host_h = {k: v.cpu() for k, v in hist.items()}
        params, hist, loss = R._rntn_batch_step(
            params, hist, *_rntn_tensors(bucket, DEVICE), model.lr,
            model.l2)
        want_p, want_h, want_loss = R._rntn_batch_step(
            host_p, host_h, *_rntn_tensors(bucket, "cpu"), model.lr,
            model.l2)
        step = {"trees": int(bucket[0].shape[0]),
                "merges": int(bucket[1].shape[1]),
                "params": _leaf_rel_errs(params, want_p),
                "hist": _leaf_rel_errs(hist, want_h),
                "loss": abs(float(loss) / float(want_loss) - 1.0)}
        steps.append(step)
        worst = max(max(step["params"].values()), max(step["hist"].values()))
        if worst > RNTN_STEP_TOL or step["loss"] > RNTN_LOSS_TOL:
            raise AssertionError(f"RNTN bucket step, card against CPU: "
                                 f"{step}")
    out = {"steps": steps, "worst_param_or_hist": max(
        max(max(s["params"].values()), max(s["hist"].values()))
        for s in steps), "worst_loss": max(s["loss"] for s in steps)}
    log(f"[parity] rntn bucket steps, card against CPU {json.dumps(out)}")
    return out


def rntn_step_profile(model, trees) -> dict:
    """One AdaGrad step on the bucket with the most merges, under
    torch.profiler after a warm-up step: device operations, busy share,
    the most frequent kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.interop import rntn_params_from_numpy
    from deeplearning4j_tpu_torch.models import rntn as R

    bucket = max(model._prepare(trees), key=lambda b: b[1].shape[1])
    inputs = _rntn_tensors(bucket, DEVICE)
    params = rntn_params_from_numpy(model.params, DEVICE)
    hist = {k: torch.ones_like(v) for k, v in params.items()}
    R._rntn_batch_step(params, hist, *inputs, model.lr, model.l2)
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        R._rntn_batch_step(params, hist, *inputs, model.lr, model.l2)
        sync()
        wall = time.perf_counter() - t0
    out = device_busy(prof, wall)
    counts = _by_name(prof, lambda e: e.count)
    merges = int(bucket[1].shape[1])
    out.update({"trees": int(bucket[0].shape[0]), "merges": merges,
                "device_ops": sum(counts.values()),
                "device_ops_per_merge": sum(counts.values()) / merges,
                "ops_by_kernel": dict(list(counts.items())[:10])})
    return out


def _rntn_fit(trees) -> dict:
    """A 1-iteration warm-up fit (it pays cuBLAS's per-shape setup), then
    the timed RNTN_ITERATIONS fit; the loss must fall."""
    from deeplearning4j_tpu_torch.models.rntn import RNTN

    walls = []
    for iterations in (1, RNTN_ITERATIONS):  # a warm-up fit, the timed one
        model = RNTN(num_hidden=RNTN_HIDDEN, num_classes=RNTN_CLASSES,
                     iterations=iterations, seed=0, device=DEVICE)
        sync()
        t0 = time.perf_counter()
        model.fit(trees)
        sync()
        walls.append(time.perf_counter() - t0)
    warm_wall, wall = walls
    t0 = time.perf_counter()
    buckets = model._prepare(trees)
    prepare_s = time.perf_counter() - t0
    steps = RNTN_ITERATIONS * len(buckets)
    losses = model.losses
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"RNTN losses not finite or not falling: "
                             f"{losses}")
    return {"model": model, "trees": len(trees),
            "vocab": len(model.word_index),
            "buckets": [[int(b[0].shape[0]), int(b[0].shape[1]),
                         int(b[1].shape[1])] for b in buckets],
            "prepare_s": prepare_s, "warmup_fit_wall_s": warm_wall,
            "fit_wall_s": wall,
            "trees_per_s": len(trees) * RNTN_ITERATIONS / wall,
            "ms_per_bucket_step": wall * 1e3 / steps,
            "merge_steps_per_iteration": sum(int(b[1].shape[1])
                                             for b in buckets),
            "losses": losses}


def rntn_phase() -> dict:
    """RNTN at Socher's width on the card: SST_TREES trees (SST's training
    size) from raw sentences through TreeVectorizer, a 3-iteration fit
    (trees/s, ms a bucket step, the loss falling) and one profiled bucket
    step; the same fit on RNTN_TREES trees; and every bucket step of
    the first iteration on those RNTN_TREES trees against the CPU."""
    from deeplearning4j_tpu_torch.models.rntn import RNTNEval
    from deeplearning4j_tpu_torch.text.corpora import TreeVectorizer

    corpora = {}
    for name, n, sst in (("sst", SST_TREES, True),
                         ("small", RNTN_TREES, False)):
        t0 = time.perf_counter()
        trees = TreeVectorizer().get_trees_with_labels(
            _rntn_sentences(n, seed=0, sst=sst))
        corpora[name] = (trees, time.perf_counter() - t0)
        if len(trees) != n:
            raise AssertionError(f"TreeVectorizer gave {len(trees)} trees "
                                 f"for {n} sentences")
    sst_trees, parse_s = corpora["sst"]
    out = {"hidden": RNTN_HIDDEN, "classes": RNTN_CLASSES,
           "iterations": RNTN_ITERATIONS, "parse_s": parse_s}
    fit = _rntn_fit(sst_trees)
    model = fit.pop("model")
    ev = RNTNEval()
    ev.eval(model, sst_trees[:64])
    out.update(fit, train_eval_64=ev.stats())
    log(f"[rntn] fit at SST's size {json.dumps(out)}")
    small = _rntn_fit(corpora["small"][0])
    small.pop("model")
    out["small"] = dict(small, parse_s=corpora["small"][1])
    log(f"[rntn] fit on {RNTN_TREES} trees {json.dumps(out['small'])}")
    out["profile"] = rntn_step_profile(model, sst_trees)
    log(f"[rntn] profiled bucket step {json.dumps(out['profile'])}")
    out["card_parity"] = rntn_card_parity(corpora["small"][0])
    return out


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _max_leaf_rel(got, want) -> float:
    """max over leaves (tensors or host arrays) of max |got - want| /
    max |want|; inf where a leaf of either tree is not finite (a NaN would
    pass every ``>`` test)."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves

    errs = [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
            for a, b in zip(map(torch.as_tensor, tree_leaves(got)),
                            map(torch.as_tensor, tree_leaves(want)))]
    return max(errs) if all(math.isfinite(e) for e in errs) else math.inf


def trainer_phase() -> dict:
    """ParameterAveragingTrainer on the MNIST MLP (batch MLP_BATCH of
    synthetic_mnist) in a real one-rank process group (NCCL on the card),
    against fit_epochs on the same batches from the same params: both
    averaging modes, then the sync step with Adam replicated and
    ZeRO-sharded. K1 launches exactly 2 a step; a sync step makes exactly
    one all-reduce (and, sharded, one all-gather)."""
    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import multihost
    from deeplearning4j_tpu_torch.parallel import trainer as T

    b, w, n = MLP_BATCH, TRAINER_WARMUP, TRAINER_STEPS
    x, y = _mnist(b * (w + n), seed=31)
    conf = mnist_mlp(MLP_H1, MLP_H2)
    init = MultiLayerNetwork(conf, device=DEVICE).init().params_tree

    def fresh():
        return MultiLayerNetwork(
            conf, params=tree_map(lambda _, a: a.clone(), init),
            device=DEVICE)

    def batches(lo, hi):
        return ListDataSetIterator(DataSet(x[lo * b:hi * b],
                                           y[lo * b:hi * b]), b)

    def timed(label, fit_warm, fit_timed, want_reduce, want_gather):
        fit_warm()
        sync()
        _kernels.reset_launches()
        pmesh.reset_collectives()
        t0 = time.perf_counter()
        fit_timed()
        sync()
        wall = time.perf_counter() - t0
        run = {"steps": n, "wall_s": wall, "ms_per_step": wall * 1e3 / n,
               "samples_per_s": b * n / wall,
               "launches": _kernels.LAUNCHES["fused_dense"],
               "all_reduce": pmesh.COLLECTIVES["all_reduce"],
               "all_gather": pmesh.COLLECTIVES["all_gather"]}
        if run["launches"] != 2 * n:
            raise AssertionError(f"{label}: fused_dense launched "
                                 f"{run['launches']} times over {n} steps, "
                                 "expected 2 a step")
        if (run["all_reduce"], run["all_gather"]) != (want_reduce,
                                                      want_gather):
            raise AssertionError(f"{label}: {run['all_reduce']} all-reduces"
                                 f" and {run['all_gather']} all-gathers over "
                                 f"{n} steps, expected {want_reduce} and "
                                 f"{want_gather}")
        return run

    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = pmesh.data_parallel_mesh()
        backend = dist.get_backend()
        if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
            raise AssertionError(f"process group backend {backend}")
        out = {"backend": backend, "world_size": dist.get_world_size(),
               "batch": b}
        plain = fresh()
        out["fit_epochs"] = timed(
            "fit_epochs", lambda: plain.fit_epochs(batches(0, w)),
            lambda: plain.fit_epochs(batches(w, w + n)), 0, 0)
        for mode, each in (("sync", True), ("local", False)):
            net = fresh()
            trainer = T.ParameterAveragingTrainer(
                net, mesh, average_each_iteration=each)
            run = timed(f"trainer {mode}",
                        lambda: trainer.fit_data_set(batches(0, w)),
                        lambda: trainer.fit_data_set(batches(w, w + n)),
                        n, 0)
            run["max_rel_err_vs_fit_epochs"] = _max_leaf_rel(
                net.params_tree, plain.params_tree)
            if run["max_rel_err_vs_fit_epochs"] > TRAINER_TOL:
                raise AssertionError(f"trainer {mode} against fit_epochs: "
                                     f"{run}")
            out[mode] = run
        ones = np.ones((b,), np.float32)

        def stepped(label, step, states, want_reduce, want_gather):
            """The sync step called directly, no host read a step."""
            state = {"p": tree_map(lambda _, a: a.clone(), init),
                     "s": states}

            def run_steps(lo, hi):
                for i in range(lo, hi):
                    state["p"], state["s"], score = step(
                        state["p"], state["s"], i, x[i * b:(i + 1) * b],
                        y[i * b:(i + 1) * b], ones, i)
                state["score"] = float(score)

            run = timed(label, lambda: run_steps(0, w),
                        lambda: run_steps(w, w + n), want_reduce,
                        want_gather)
            run["final_score"] = state["score"]
            run["params"] = state["p"]
            return run

        # the one all-reduce alone, on a buffer of the sync step's size
        # (every grad, the loss sum and the weight sum)
        from deeplearning4j_tpu_torch._device import tree_leaves

        flat = torch.zeros(sum(t.numel() for t in tree_leaves(init)) + 2,
                           device=DEVICE)
        calls = 50
        mesh.all_reduce(flat)
        sync()
        t0 = time.perf_counter()
        for _ in range(calls):
            mesh.all_reduce(flat)
        host_ms = (time.perf_counter() - t0) * 1e3 / calls
        sync()
        out["all_reduce_alone"] = {
            "floats": flat.numel(), "calls": calls,
            "wall_ms_per_call": (time.perf_counter() - t0) * 1e3 / calls,
            "host_enqueue_ms_per_call": host_ms,
            "device_ms": (device_ms(lambda: mesh.all_reduce(flat))
                          if DEVICE == "cuda" else None)}
        from deeplearning4j_tpu_torch.nn import functional as F

        # where the trainer's time goes: its step without the per-batch
        # host read, and again with the all-reduce ablated
        for label, ablate in (("sync_step", False),
                              ("sync_step_no_collective", True)):
            run = stepped(label, T.make_sync_train_step(
                conf, mesh, ablate_collectives=ablate),
                F.init_train_state(conf, init), 0 if ablate else n, 0)
            run.pop("params")
            out[label] = run
        adam = {}
        for mode in ("replicated", "sharded"):
            cfg = OptimizerConfig(name="adam", lr=ADAM_LR,
                                  update_sharding=mode)
            adam[mode] = stepped(
                f"adam {mode}", T.make_sync_train_step(conf, mesh,
                                                       optimizer=cfg),
                T.init_sync_opt_state(cfg, init, mesh), n,
                n if mode == "sharded" else 0)
        err = max(float((a - c).abs().max()) for a, c in zip(
            tree_leaves(adam["sharded"].pop("params")),
            tree_leaves(adam["replicated"].pop("params"))))
        adam["sharded_vs_replicated_max_abs"] = err
        if err > ZERO_TOL:
            raise AssertionError(f"Adam sharded against replicated: {err}")
        out["adam"] = adam
    finally:
        multihost.shutdown()
    log(f"[trainer] {json.dumps(out)}")
    return out


def slice7(smi: str) -> dict:
    """Phase 11: the RNTN (no kernel on its path) and the data-parallel
    trainer (K1 on its one rank) on the card."""
    out = {"rntn": rntn_phase(), "trainer": trainer_phase()}
    r, t = out["rntn"], out["trainer"]
    summary = {"rntn_trees": r["trees"],
               "rntn_trees_per_s": r["trees_per_s"],
               "rntn_small_trees_per_s": r["small"]["trees_per_s"],
               "rntn_ms_per_bucket_step": r["ms_per_bucket_step"],
               "rntn_device_ops_per_merge":
                   r["profile"]["device_ops_per_merge"],
               "rntn_busy_share": r["profile"]["busy_share"],
               "fit_epochs_samples_per_s": t["fit_epochs"]["samples_per_s"],
               "trainer_sync_samples_per_s": t["sync"]["samples_per_s"],
               "trainer_local_samples_per_s": t["local"]["samples_per_s"],
               "sync_step_samples_per_s": t["sync_step"]["samples_per_s"],
               "sync_step_no_collective_samples_per_s":
                   t["sync_step_no_collective"]["samples_per_s"],
               "adam_replicated_samples_per_s":
                   t["adam"]["replicated"]["samples_per_s"],
               "adam_sharded_samples_per_s":
                   t["adam"]["sharded"]["samples_per_s"]}
    log(f"[slice7] {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------------------ phase 12 ----

# the data-parallel halves of the LM and Word2Vec and the in-process
# scaleout plane, in a one-rank NCCL group (the card is one H100: world
# size 1 throughout, no multi-card figure)
DP_STEPS = 3          # composed steps held against the single-device step
DP_TIMED = 5          # more steps of each, timed
DP_TOL = 1e-6         # params of each leaf's max, and losses, relative
RUNNER_JOBS, RUNNER_WORKERS = 12, 4   # batch-512 synthetic_mnist jobs
# a round's average against the CPU's round from the same incoming params,
# of each leaf's max; a leaf over it (a ReLU unit flipping at its kink
# between K1 and the CPU) is held to KINK_TOL of the round's update. A
# flip moves one example's share (1/MLP_BATCH) of one job's gradient
# column: 3.0e-5 and 3.3e-5 of the leaf's max, once in a run, in two
# runs on an H100, the second 1.6e-3 of its round's update, past phase
# 5's single-batch MLP_GRAD_TOL. KINK_TOL allows a few examples' share; a
# fault of the plumbing (a job lost or counted twice) moves a leaf by a
# job's whole share of the update, 1/RUNNER_WORKERS.
RUNNER_TOL = 1e-5
KINK_TOL = 4 / MLP_BATCH
W2V_PERF_JOBS, W2V_PERF_PAIRS = 3, 8192


class _IdentityMesh:
    """A one-rank ("data",) mesh with no group: the CPU side of a card
    step's parity, whose collectives are the identity."""
    axis_names = ("data",)
    shape = {"data": 1}
    coords = {"data": 0}
    size, rank, device, grouped = 1, 0, None, False

    def all_reduce(self, t):
        return t

    def all_gather(self, t):
        return t


def _timed_steps(step, carry, batch, n):
    """``n`` steps of ``step`` from ``carry`` (params, or params and
    state), fenced: (carry, losses, ms a step)."""
    sync()
    t0 = time.perf_counter()
    losses = []
    for _ in range(n):
        out = step(*carry, *batch)
        carry = out[:len(carry)]
        losses.append(out[len(carry)])
    sync()
    return carry, [float(x) for x in losses], \
        (time.perf_counter() - t0) * 1e3 / n


def lm_dp_phase(mesh) -> dict:
    """(a) make_composed_train_step on the one-rank ("data",) mesh at the
    flagship's full width and training shape, with SGD, Adam replicated
    and Adam ZeRO-sharded, against make_single_device_train_step from the
    same params and batch: DP_STEPS steps each, params and losses within
    DP_TOL; K3f, K3k and K3q exactly n_layers x steps on the composed
    run; 2 all-reduces a step (and 1 all-gather sharded); ms a step and
    tokens/s of both."""
    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh

    params, tokens, targets = _train_setup()
    tk, tg = T.shard_lm_batch(tokens, targets, mesh, device=DEVICE)

    def clone(tree):
        return tree_map(lambda _, a: a.clone(), tree)

    out = {"world_size": mesh.size, "batch": [TRAIN_B, TRAIN_T],
           "steps": DP_STEPS}
    for mode in ("sgd", "adam_replicated", "adam_sharded"):
        opt = (None if mode == "sgd" else OptimizerConfig(
            name="adam", lr=ADAM_LR, update_sharding=mode.split("_")[1]))
        single = T.make_single_device_train_step(
            N_HEADS, optimizer=None if opt is None else
            OptimizerConfig(name="adam", lr=ADAM_LR), device=DEVICE)
        dp = T.make_composed_train_step(mesh, N_HEADS, 0, optimizer=opt,
                                        device=DEVICE)
        p1 = clone(params)
        c1 = (p1,) if opt is None else (
            p1, T.init_lm_opt_state("adam", p1, device=DEVICE))
        p2 = T.shard_lm_params(clone(params), mesh, device=DEVICE)
        c2 = (p2,) if opt is None else (
            p2, T.init_lm_opt_state(opt, p2, mesh, device=DEVICE))
        c1, l1, ms1 = _timed_steps(single, c1, (tokens, targets), DP_STEPS)
        _kernels.reset_launches()
        pmesh.reset_collectives()
        c2, l2, ms2 = _timed_steps(dp, c2, (tk, tg), DP_STEPS)
        launches = _check_launches(f"data-parallel {mode}", DP_STEPS)
        coll = dict(pmesh.COLLECTIVES)
        want = {"all_reduce": 2 * DP_STEPS,
                "all_gather": DP_STEPS if mode == "adam_sharded" else 0,
                "all_to_all": 0, "send_recv": 0, "broadcast": 0}
        if coll != want:
            raise AssertionError(f"data-parallel {mode}: collectives {coll},"
                                 f" expected {want}")
        err = _max_leaf_rel(c2[0], c1[0])
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
        run = {"max_leaf_rel_err": err, "max_loss_rel_err": loss_err,
               "losses": l2, "launches": {k: launches[k] for k in
                                          TRAIN_KERNELS},
               "collectives": coll}
        if err > DP_TOL or loss_err > DP_TOL or not l2[-1] < l2[0]:
            raise AssertionError(f"data-parallel {mode} against the single-"
                                 f"device step: {run}")
        # timed: more steps of each from where they are
        c1, _, ms1 = _timed_steps(single, c1, (tokens, targets), DP_TIMED)
        c2, _, ms2 = _timed_steps(dp, c2, (tk, tg), DP_TIMED)
        run.update({
            "ms_per_step": ms2, "single_device_ms_per_step": ms1,
            "tokens_per_s": TRAIN_B * TRAIN_T * 1e3 / ms2,
            "single_device_tokens_per_s": TRAIN_B * TRAIN_T * 1e3 / ms1})
        out[mode] = run
    log(f"[lm dp] {json.dumps(out)}")
    return out


def _w2v_step_inputs(v, d, b, seed=3):
    """Random tables and a global pair batch at (V, D, batch), zipf-drawn
    words, a unigram^0.75 sampling table and random Huffman-like paths of
    up to 20 nodes."""
    import torch

    from deeplearning4j_tpu_torch.models.word2vec import build_neg_table

    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, v + 1)
    probs /= probs.sum()
    lmax = 20
    lens = rng.integers(1, lmax + 1, v)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return {
        "syn0": t(((rng.random((v, d)) - 0.5) / d).astype(np.float32)),
        "syn1": t((rng.normal(size=(v, d)) * 0.1).astype(np.float32)),
        "centers": t(rng.choice(v, b, p=probs).astype(np.int64)),
        "contexts": t(rng.choice(v, b, p=probs).astype(np.int64)),
        "weights": t(np.ones(b, np.float32)),
        "neg_table": build_neg_table(probs ** 0.75, device="cpu"),
        "pts": t(rng.integers(0, v - 1, (v, lmax)).astype(np.int64)),
        "cds": t(rng.integers(0, 2, (v, lmax)).astype(np.float32)),
        "msk": t((np.arange(lmax)[None, :] < lens[:, None])
                 .astype(np.float32)),
    }


def w2v_mesh_phase(mesh, device_epoch_words_per_s) -> dict:
    """(b) Word2Vec's sharded steps at word2vec_large's width: one SGNS
    step (shared and per-pair negatives) and one HS step on the card
    against the same step on the CPU from the same state and draws
    (W2V_CARD_TOL); then a Word2Vec(mesh=...) fit timed, words/s beside
    the device-epoch path's (phase 10)."""
    import torch

    from deeplearning4j_tpu_torch.models import word2vec as w2v

    v, d, b = W2V_LARGE["vocab"], W2V_LARGE["layer_size"], \
        W2V_LARGE["batch_size"]
    inp = _w2v_step_inputs(v, d, b)
    orig = _cpu_draws(w2v)
    out = {"vocab": v, "layer_size": d, "batch_pairs": b}
    try:
        for run in ("sgns shared", "sgns per-pair", "hs"):
            res = {}
            for dev, m in (("cpu", _IdentityMesh()), (DEVICE, mesh)):
                a = {k: x.to(dev).clone() for k, x in inp.items()}
                t0 = time.perf_counter()
                if run == "hs":
                    step = w2v.make_sharded_hs_step(m)
                    c = a["contexts"]
                    s0, s1, loss = step(a["syn0"], a["syn1"][:v - 1],
                                        a["centers"], a["pts"][c],
                                        a["cds"][c], a["msk"][c],
                                        a["weights"], 0.025)
                else:
                    ng = 64 if run == "sgns shared" else 0
                    step = w2v.make_sharded_sgns_step(m, 5, ng)
                    s0, s1, loss = step(a["syn0"], a["syn1"], a["centers"],
                                        a["contexts"], a["weights"],
                                        a["neg_table"], 0.025, 7)
                loss = float(loss)
                res[dev] = (s0.cpu(), s1.cpu(), loss,
                            (time.perf_counter() - t0) * 1e3)
            cpu, card = res["cpu"], res[DEVICE]
            errs = [float((g - w).abs().max()) for g, w in
                    zip(card[:2], cpu[:2])]
            moved = float((cpu[0] - inp["syn0"]).abs().max())
            out[run] = {"max_abs_err": errs,
                        "loss_rel_err": abs(card[2] - cpu[2]) / abs(cpu[2]),
                        "moved": moved, "card_ms_first_call": card[3],
                        "cpu_ms": cpu[3]}
            if max(errs) > W2V_CARD_TOL or moved == 0 \
                    or out[run]["loss_rel_err"] > 1e-5:
                raise AssertionError(f"word2vec sharded {run} step: card "
                                     f"against CPU {out[run]}")
    finally:
        w2v._keep_uniforms, w2v._window_draws, w2v._neg_slots = orig
    del inp
    # the mesh fit at word2vec_large: host pairs, 2 dense V x D
    # all-reduces a step
    large = _w2v_corpus(**W2V_LARGE)
    vec = w2v.Word2Vec(sentence_iterator=_sentences(large), mesh=mesh,
                       window=5, negative=5, iterations=1, sample=1e-3,
                       seed=1, layer_size=d, batch_size=b)
    vec.build_vocab()
    vec.fit()           # warm
    vec.block_until_ready()
    sync()
    t0 = time.perf_counter()
    vec.fit()
    vec.block_until_ready()
    wall = time.perf_counter() - t0
    words = sum(len(s.split()) for s in large)
    steps = vec.last_fit_timings["n_dispatches"]
    table = vec.lookup_table
    if not np.isfinite(table.syn0).all() or vec.total_words_trained <= 0:
        raise AssertionError("word2vec mesh fit: non-finite table or no "
                             "pairs trained")
    out["mesh_fit"] = {
        "words": words, "wall_s": wall, "words_per_s": words / wall,
        "device_epoch_words_per_s": device_epoch_words_per_s,
        "steps": steps, "ms_per_step": wall * 1e3 / max(steps, 1),
        "all_reduce_bytes_per_step": 2 * v * d * 4,
        "last_fit_timings": vec.last_fit_timings,
        "note": ("each mesh step all-reduces the dense V x D gradient "
                 "tables of syn0 and syn1neg (with their counts) even on "
                 "one rank")}
    log(f"[w2v mesh] {json.dumps(out)}")
    return out


def _sentences(sents):
    from deeplearning4j_tpu_torch.text.sentence_iterator import (
        CollectionSentenceIterator,
    )

    return CollectionSentenceIterator(sents)


def _hold_round(what, r, got, want, start, errs, kinks) -> None:
    """Round ``r``'s average ``got`` (leaves) against the CPU's ``want``
    from the same incoming params ``start``: RUNNER_TOL of each leaf's
    max, appended to ``errs``. A ReLU unit within f32 noise of its kink
    switches between K1 and the CPU (phase 5): a leaf over RUNNER_TOL is
    held to KINK_TOL of the round's update's max, and listed in
    ``kinks``."""
    for i, (g, w, s) in enumerate(zip(got, want, start)):
        err = float(np.abs(g - w).max())
        rel = err / float(np.abs(w).max())
        errs.append(rel)
        if rel > RUNNER_TOL:
            upd = float(np.abs(w - s).max())
            kinks.append({"round": r, "leaf": i, "rel_err": rel,
                          "of_update_max": err / upd})
            if err > KINK_TOL * upd:
                raise AssertionError(
                    f"{what} round {r} leaf {i} against the CPU: {rel} of "
                    f"the leaf's max, {err / upd} of the update's max")


def runner_phase() -> dict:
    """(c) LocalDistributedRunner on the MNIST MLP: RUNNER_JOBS batch-512
    synthetic_mnist jobs, MultiLayerNetworkWorkPerformer on the card,
    RUNNER_WORKERS worker threads. The sync run (IterativeReduceWorkRouter)
    from one seed's params put in through update(): each round's average
    against the CPU's round from the same incoming params (RUNNER_TOL of
    each leaf's max; a leaf a ReLU kink flip moves, KINK_TOL of the
    round's update), K1 exactly 2 x iterations x jobs, samples/s beside
    fit_epochs' on the
    same batches. A HogWild run finishes and its score falls. The trained
    net through save_checkpoint / load_checkpoint and
    save_checkpoint_to_store over mem://, torch.equal."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.scaleout import (
        InMemoryStateTracker,
        LocalDistributedRunner,
    )
    from deeplearning4j_tpu_torch.scaleout import blobstore
    from deeplearning4j_tpu_torch.scaleout.aggregator import (
        ParameterAveragingAggregator,
    )
    from deeplearning4j_tpu_torch.scaleout.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from deeplearning4j_tpu_torch.scaleout.job import DataSetJobIterator
    from deeplearning4j_tpu_torch.scaleout.perform import (
        MultiLayerNetworkWorkPerformer,
    )
    from deeplearning4j_tpu_torch.scaleout.workrouter import (
        HogWildWorkRouter,
    )

    b, jobs = MLP_BATCH, RUNNER_JOBS
    x, y = _mnist(b * jobs, seed=37)
    conf = mnist_mlp(MLP_H1, MLP_H2)
    conf_json = conf.to_json()
    iters = conf.conf(0).num_iterations
    # the initial params, drawn once (the conf's seed, on the CPU)
    init = MultiLayerNetwork(conf, device="cpu").init().params().numpy()

    def job_iter():
        return DataSetJobIterator(ListDataSetIterator(DataSet(x, y), b))

    class Rounds:
        """A ModelSaver the sync runner calls after every aggregation:
        it keeps each round's average."""
        def __init__(self):
            self.saved = []

        def save(self, model):
            self.saved.append(np.array(model))

    def factory():
        performer = MultiLayerNetworkWorkPerformer(conf_json, device=DEVICE)
        performer.update(init)
        return performer

    rounds = Rounds()
    tracker = InMemoryStateTracker()
    runner = LocalDistributedRunner(factory, job_iter(),
                                    num_workers=RUNNER_WORKERS,
                                    tracker=tracker, model_saver=rounds)
    sync()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    final = runner.train()
    sync()
    wall = time.perf_counter() - t0
    launches = _kernels.LAUNCHES["fused_dense"]
    if launches != 2 * iters * jobs:
        raise AssertionError(f"runner: fused_dense launched {launches} "
                             f"times, expected 2 x {iters} x {jobs}")
    n_rounds = jobs // RUNNER_WORKERS
    if len(rounds.saved) != n_rounds or tracker.count("jobs_done") != jobs:
        raise AssertionError(f"runner: {len(rounds.saved)} rounds, "
                             f"{tracker.count('jobs_done')} jobs")
    # each round on the CPU from the same incoming params, per leaf
    shape_net = MultiLayerNetwork(conf, device="cpu").init()

    def leaves(flat):
        shape_net.set_params(flat)
        return [a.numpy().copy() for a in tree_leaves(shape_net.params_tree)]

    errs, kinks, incoming = [], [], init
    for r in range(n_rounds):
        results = []
        for j in range(r * RUNNER_WORKERS, (r + 1) * RUNNER_WORKERS):
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.set_params(incoming)
            net.fit(DataSet(x[j * b:(j + 1) * b], y[j * b:(j + 1) * b]))
            results.append(net.params().numpy())
        _hold_round("runner", r, leaves(rounds.saved[r]),
                    leaves(np.mean(results, axis=0)), leaves(incoming),
                    errs, kinks)
        incoming = rounds.saved[r]
    # fit_epochs on the same batches, for speed
    plain = MultiLayerNetwork(conf, device=DEVICE).init()
    plain.set_params(init)
    plain.fit_epochs(ListDataSetIterator(DataSet(x[:2 * b], y[:2 * b]), b))
    sync()
    t0 = time.perf_counter()
    plain.fit_epochs(ListDataSetIterator(DataSet(x, y), b))
    sync()
    fit_wall = time.perf_counter() - t0
    out = {"sync": {"jobs": jobs, "workers": RUNNER_WORKERS,
                    "rounds": n_rounds, "wall_s": wall,
                    "samples_per_s": b * jobs / wall,
                    "launches": launches,
                    "max_leaf_rel_err_vs_cpu": max(errs),
                    "leaves_over_runner_tol": kinks},
           "fit_epochs_samples_per_s": b * jobs / fit_wall}
    # HogWild: finishes, the score falls
    scores = []

    class Recording(MultiLayerNetworkWorkPerformer):
        def perform(self, job):
            super().perform(job)
            scores.append(job.score)

    tracker = InMemoryStateTracker()

    def hog_factory():
        performer = Recording(conf_json, device=DEVICE)
        performer.update(init)
        return performer

    hog = LocalDistributedRunner(
        hog_factory, job_iter(), num_workers=RUNNER_WORKERS,
        tracker=tracker,
        router=HogWildWorkRouter(tracker, ParameterAveragingAggregator()))
    t0 = time.perf_counter()
    hog_final = hog.train()
    sync()
    hwall = time.perf_counter() - t0
    first, last = np.mean(scores[:2]), np.mean(scores[-2:])
    out["hogwild"] = {"jobs": int(tracker.count("jobs_done")),
                      "aggregations": int(tracker.count("aggregations")),
                      "wall_s": hwall, "samples_per_s": b * jobs / hwall,
                      "first_scores": first, "last_scores": last}
    if hog_final is None or tracker.count("jobs_done") != jobs \
            or not last < first:
        raise AssertionError(f"hogwild run: {out['hogwild']}")
    # the trained net through the single-file checkpoint and the blob seam
    net = MultiLayerNetwork(conf, device=DEVICE).init()
    net.set_params(final)
    net.fit(DataSet(x[:b], y[:b]))
    import tempfile

    with tempfile.TemporaryDirectory() as work:
        path = save_checkpoint(f"{work}/ckpt", net)
        back, it = load_checkpoint(path, device=DEVICE)
    store = blobstore.open_store("mem://chip-smoke")
    key = blobstore.save_checkpoint_to_store(store, "ckpt.npz", net)
    back2, it2 = blobstore.load_checkpoint_from_store(store, key,
                                                      device=DEVICE)
    for label, other, i in (("file", back, it), ("mem://", back2, it2)):
        same = all(torch.equal(a, c) for a, c in zip(
            tree_leaves((net.params_tree, net._train_state)),
            tree_leaves((other.params_tree, other._train_state))))
        if not same or i != net._iteration or \
                other.params().device.type != DEVICE:
            raise AssertionError(f"checkpoint round trip ({label}) differs")
    out["checkpoint"] = {"iteration": it, "equal": True}
    log(f"[runner] {json.dumps(out)}")
    return out


def w2v_performer_phase() -> dict:
    """(d) Word2VecWorkPerformer: W2V_PERF_JOBS jobs of W2V_PERF_PAIRS
    pairs at word2vec_large's width (D 256) over the vocab of a
    2,000-sentence draw of its corpus, on the card and on the CPU from the
    same tables and draws (W2V_CARD_TOL)."""
    from deeplearning4j_tpu_torch.models import word2vec as w2v
    from deeplearning4j_tpu_torch.scaleout.job import Job
    from deeplearning4j_tpu_torch.scaleout.nlp_perform import (
        Word2VecWorkPerformer,
    )

    vec = w2v.Word2Vec(sentence_iterator=_sentences(
        _w2v_corpus(2_000, 100, W2V_LARGE["vocab"])), device="cpu",
        layer_size=W2V_LARGE["layer_size"])
    vec.build_vocab()
    rng = np.random.default_rng(1)
    centers, contexts = vec._pairs_from_flat(vec._flat, vec._sid, rng)
    perm = rng.permutation(len(centers))
    centers, contexts = centers[perm], contexts[perm]
    orig = _cpu_draws(w2v)
    try:
        perf = {dev: Word2VecWorkPerformer(
            vec.vocab, layer_size=W2V_LARGE["layer_size"], negative=5,
            lr=0.025, total_pairs=W2V_PERF_JOBS * W2V_PERF_PAIRS, seed=1,
            device=dev) for dev in ("cpu", DEVICE)}
        errs = []
        for j in range(W2V_PERF_JOBS):
            lo = j * W2V_PERF_PAIRS
            work = (centers[lo:lo + W2V_PERF_PAIRS],
                    contexts[lo:lo + W2V_PERF_PAIRS])
            res = {}
            for dev, p in perf.items():
                job = Job(work)
                p.perform(job)
                res[dev] = job.result
            errs.append(float(np.abs(res[DEVICE] - res["cpu"]).max()))
    finally:
        w2v._keep_uniforms, w2v._window_draws, w2v._neg_slots = orig
    out = {"vocab": vec.vocab.num_words(), "jobs": W2V_PERF_JOBS,
           "pairs_per_job": W2V_PERF_PAIRS, "max_abs_err": errs}
    if max(errs) > W2V_CARD_TOL:
        raise AssertionError(f"Word2VecWorkPerformer card against CPU: "
                             f"{out}")
    log(f"[w2v performer] {json.dumps(out)}")
    return out


def slice8(smi: str, device_epoch_words_per_s) -> dict:
    """Phase 12: the LM's data-parallel step (K3f, K3k, K3q on the rank),
    Word2Vec's sharded steps and mesh fit, LocalDistributedRunner (K1 in
    every worker's fit) and the NLP performer, in a one-rank NCCL group."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        mesh = pmesh.data_parallel_mesh()
        backend = dist.get_backend()
        if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
            raise AssertionError(f"process group backend {backend}")
        log(f"[slice8] {backend} group of world size {mesh.size}: one card, "
            "no multi-card figure")
        out = {"backend": backend, "world_size": mesh.size,
               "lm_dp": lm_dp_phase(mesh),
               "w2v_mesh": w2v_mesh_phase(mesh, device_epoch_words_per_s)}
    finally:
        multihost.shutdown()
    out["runner"] = runner_phase()
    out["w2v_performer"] = w2v_performer_phase()
    out["wall_s"] = time.perf_counter() - t0
    lm, w, r = out["lm_dp"], out["w2v_mesh"]["mesh_fit"], out["runner"]
    summary = {
        "lm_dp_ms_per_step": {m: lm[m]["ms_per_step"] for m in
                              ("sgd", "adam_replicated", "adam_sharded")},
        "lm_single_device_ms_per_step": {
            m: lm[m]["single_device_ms_per_step"] for m in
            ("sgd", "adam_replicated", "adam_sharded")},
        "lm_dp_tokens_per_s": lm["sgd"]["tokens_per_s"],
        "w2v_mesh_words_per_s": w["words_per_s"],
        "w2v_device_epoch_words_per_s": w["device_epoch_words_per_s"],
        "runner_samples_per_s": r["sync"]["samples_per_s"],
        "hogwild_samples_per_s": r["hogwild"]["samples_per_s"],
        "fit_epochs_samples_per_s": r["fit_epochs_samples_per_s"],
        "wall_s": out["wall_s"]}
    log(f"[slice8] {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------------------ phase 13 ----

# the serving fleet at the flagship's width: two FleetReplicas of N_SLOTS x
# MAX_LEN in this process, each with its own TCP clients of a
# StateTrackerServer on 127.0.0.1, behind a FleetRouter; FLEET_REQUESTS
# greedy requests of MAX_NEW tokens with prompts across the buckets
# (PROMPT_LENS in turn), in two sessions and unpinned, driven by
# run_open_loop; the bf16 runs take FLEET_TIMED_REQUESTS of the same mix
FLEET_REPLICAS = ("r1", "r2")
FLEET_REQUESTS, FLEET_TIMED_REQUESTS = 24, 96
FLEET_SESSIONS = ("s0", "s1", None)
# offered load: this multiple of the request rate one bf16 engine sustains
# in a burst, so the schedule asks more than one engine gives
FLEET_LOAD = 1.5
FLEET_SEED = 13     # the open-loop arrival schedule's
# the router's heartbeat windows: wider than the JAX defaults (1 s, 3 s);
# two serve threads share the process's GIL with the heartbeats
FLEET_STALE_S, FLEET_DEAD_S = 2.0, 5.0
FLEET_CLI_REQUESTS = 4
# DistributedMaster on the MNIST MLP: batch-512 jobs over DIST_WORKERS
# in-process workers, then DIST_PROC_JOBS through one worker process
DIST_JOBS, DIST_WORKERS, DIST_PROC_JOBS = 8, 2, 4
FLEET_REPORT = ("duration_s", "tokens_per_sec", "offered_rps",
                "first_token_p50_ms", "first_token_p99_ms",
                "latency_p50_ms", "latency_p99_ms")


def _fleet_prompts(seed: int, n: int) -> list:
    rng = np.random.RandomState(seed)
    return [_prompt(rng, PROMPT_LENS[i % len(PROMPT_LENS)])
            for i in range(n)]


def _fleet_sessions(n: int) -> list:
    return [FLEET_SESSIONS[i % len(FLEET_SESSIONS)] for i in range(n)]


def _engine_kwargs(serve_dtype, seed) -> dict:
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    return {"n_slots": N_SLOTS, "max_len": MAX_LEN,
            "serve_dtype": serve_dtype, "registry": MetricsRegistry(),
            "seed": seed}


def _record_submits(obj) -> list:
    """Wrap ``obj.submit`` on the instance so every request it returns is
    kept in the list returned (the replica's serve loop and loadgen call
    it through the instance)."""
    reqs, submit = [], obj.submit

    def recording(*args, **kwargs):
        reqs.append(submit(*args, **kwargs))
        return reqs[-1]

    obj.submit = recording
    return reqs


class _Fleet:
    """A tracker server on 127.0.0.1:0, replicas built from its address
    string by FleetReplica.from_live_params (two TCP clients each) over
    ``params`` on the card, and a FleetRouter over its own
    StateTrackerClient. ``submitted[rid]`` keeps each replica engine's
    requests."""

    def __init__(self, params, serve_dtype, rids=FLEET_REPLICAS,
                 cold_start=None):
        from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
            StateTrackerClient,
            StateTrackerServer,
        )
        from deeplearning4j_tpu_torch.serve import FleetRouter
        from deeplearning4j_tpu_torch.telemetry.registry import (
            MetricsRegistry,
        )

        self.params, self.serve_dtype = params, serve_dtype
        self.server = StateTrackerServer()
        self.replicas, self.submitted = {}, {}
        self.client = None
        try:
            for rid in rids:
                self.add(rid)
            self.client = StateTrackerClient(self.server.address)
            self.router = FleetRouter(
                self.client, registry=MetricsRegistry(),
                stale_after_s=FLEET_STALE_S, dead_after_s=FLEET_DEAD_S,
                cold_start=cold_start)
            self.wait_alive(set(rids))
        except BaseException:
            self.close()
            raise

    def add(self, rid: str):
        from deeplearning4j_tpu_torch.serve import FleetReplica

        rep = FleetReplica.from_live_params(
            self.params, N_HEADS, self.server.address, rid, device=DEVICE,
            engine_kwargs=_engine_kwargs(self.serve_dtype,
                                         len(self.replicas)))
        self.submitted[rid] = _record_submits(rep.engine)
        self.replicas[rid] = rep
        rep.start()
        return rep

    def wait_alive(self, rids, timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        while not rids <= {r["replica_id"] for r in
                           self.router.fleet_snapshot()["replicas"]
                           if r["state"] == "alive"}:
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet replicas {sorted(rids)} not "
                                     f"alive within {timeout_s} s")
            self.router.step()

    def reset_records(self) -> None:
        for reqs in self.submitted.values():
            reqs.clear()

    def k3f_expected(self) -> int:
        return N_LAYERS * sum(
            _kernel_admissions(self.replicas[rid].engine, reqs)
            for rid, reqs in self.submitted.items())

    def close(self) -> None:
        for rep in self.replicas.values():
            rep.stop()
        if self.client is not None:
            self.client.close()
        self.server.shutdown()


class _RpcCounts:
    """Tracker RPCs by method, over every StateTrackerClient in this
    process, while the context is open (a dict update a call)."""

    def __enter__(self):
        from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
            StateTrackerClient,
        )

        self.counts, lock = {}, threading.Lock()
        self._cls, call = StateTrackerClient, StateTrackerClient._call

        def counting(client, method, *args, **kwargs):
            with lock:
                self.counts[method] = self.counts.get(method, 0) + 1
            return call(client, method, *args, **kwargs)

        self._call, StateTrackerClient._call = call, counting
        return self

    def __exit__(self, *exc):
        self._cls._call = self._call


def _fleet_drive(target, prompts, rate, sessions=None, profiled=False):
    """run_open_loop over ``target`` (a FleetRouter or a DecodeEngine),
    the launches counted from 0 over exactly that run: (report, the
    requests it submitted, K3f's launches, the device busy record or
    None). Every request must finish its MAX_NEW tokens."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.serve import run_open_loop

    reqs = _record_submits(target)
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if profiled else contextlib.nullcontext())
    sync()
    _kernels.reset_launches()
    try:
        with ctx as prof:
            report = run_open_loop(target, prompts, rate,
                                   max_new_tokens=MAX_NEW, seed=FLEET_SEED,
                                   sessions=sessions)
            sync()
    finally:
        del target.submit
    launches = _kernels.LAUNCHES["flash_attention_fwd"]
    for r in reqs:
        if not (r.done.is_set() and r.finish_reason == "max_new_tokens"
                and len(r.generated) == MAX_NEW):
            raise AssertionError(f"fleet: request {r.rid} (prompt "
                                 f"{len(r.prompt)}) ended "
                                 f"{r.finish_reason!r} with "
                                 f"{len(r.generated)} tokens")
    busy = device_busy(prof, report.duration_s) if profiled else None
    return report, reqs, launches, busy


def _fleet_checks(fleet, reqs, launches, sessions) -> dict:
    """K3f launched exactly n_layers x the replicas' kernel admissions
    (never 0), each session rode one replica, nothing was requeued."""
    want = fleet.k3f_expected()
    if launches != want or want == 0:
        raise AssertionError(f"fleet: flash_attention_fwd launched "
                             f"{launches} times, the replicas' admissions "
                             f"expect {want}")
    rode = {}
    for r, s in zip(reqs, sessions):
        if s is not None:
            rode.setdefault(s, set()).add(r.replica)
    snap = fleet.router.fleet_snapshot()
    if any(len(v) != 1 for v in rode.values()) or snap["requeued_total"]:
        raise AssertionError(f"fleet: sessions rode {rode}, requeued "
                             f"{snap['requeued_total']}")
    return {"k3f_launches": launches,
            "admissions": {rid: len(r) for rid, r in fleet.submitted.items()},
            "sessions": {s: sorted(v)[0] for s, v in rode.items()}}


def fleet_phase(params, prompts, want, smi: str) -> dict:
    """(a) The fleet on the card: the rate one bf16 engine sustains in a
    burst sets the offered load (FLEET_LOAD of it); at f32 the fleet's
    streams of ``prompts`` against one engine's (``want``, phase 3b's tie
    rule), K3f's count, sessions, no requeue; at bf16, warmed,
    FLEET_TIMED_REQUESTS through the fleet and through one engine on the
    same schedule, and the fleet once more profiled."""
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    sessions = _fleet_sessions(len(prompts))
    timed = _fleet_prompts(42, FLEET_TIMED_REQUESTS)
    timed_sessions = _fleet_sessions(FLEET_TIMED_REQUESTS)
    warm = _fleet_prompts(43, FLEET_REQUESTS)
    one = DecodeEngine(params, N_HEADS, device=DEVICE,
                       **_engine_kwargs("bf16", 0))
    for p in warm:
        one.submit(p, max_new_tokens=MAX_NEW)
    one.run_until_idle()
    sync()
    t0 = time.perf_counter()
    for p in timed:
        one.submit(p, max_new_tokens=MAX_NEW)
    one.run_until_idle()
    sync()
    sustained = len(timed) / (time.perf_counter() - t0)
    rate = FLEET_LOAD * sustained
    log(f"[fleet] one bf16 engine sustains {sustained:.2f} requests/s "
        f"({len(timed)} in one burst); offered load {rate:.2f} requests/s")

    # f32: the fleet's streams against one engine's
    fleet = _Fleet(params, None)
    try:
        rep, reqs, launches, _ = _fleet_drive(fleet.router, prompts, rate,
                                              sessions)
        f32 = _fleet_checks(fleet, reqs, launches, sessions)
    finally:
        fleet.close()
    f32["diverged_near_tie"] = _fp_check_streams(params, "fleet", prompts,
                                                 want, reqs)
    f32.update({k: getattr(rep, k) for k in FLEET_REPORT})
    log(f"[fleet] f32: {json.dumps(f32)}")

    # bf16: timed, fleet and one engine on the same schedule
    fleet = _Fleet(params, "bf16")
    try:
        _fleet_drive(fleet.router, warm, rate, _fleet_sessions(len(warm)))
        fleet.reset_records()
        with _RpcCounts() as rpcs:
            rep, reqs, launches, _ = _fleet_drive(fleet.router, timed, rate,
                                                  timed_sessions)
        bf16 = _fleet_checks(fleet, reqs, launches, timed_sessions)
        bf16.update({k: getattr(rep, k) for k in FLEET_REPORT})
        # the control plane's cost: tracker round trips a generated token
        bf16["tracker_rpcs"] = dict(sorted(rpcs.counts.items()))
        bf16["tracker_rpcs_per_token"] = (sum(rpcs.counts.values())
                                          / rep.tokens_out)
        fleet.reset_records()
        prep, _, _, busy = _fleet_drive(
            fleet.router, _fleet_prompts(44, FLEET_REQUESTS), rate,
            sessions, profiled=True)
    finally:
        fleet.close()
    bf16["profiled"] = {"tokens_per_sec": prep.tokens_per_sec,
                        "busy_share": busy["busy_share"],
                        "device_busy_ms": busy["device_busy_ms"],
                        "top_kernels_ms": dict(list(
                            busy["top_kernels_ms"].items())[:4])}
    orep, _, olaunches, _ = _fleet_drive(one, timed, rate)
    engine = {k: getattr(orep, k) for k in FLEET_REPORT}
    engine["k3f_launches"] = olaunches
    del one
    beats = bf16["tokens_per_sec"] > engine["tokens_per_sec"]
    out = {"sustained_rps": sustained, "offered_rps": rate, "f32": f32,
           "bf16": {"fleet": bf16, "one_engine": engine,
                    "fleet_beats_one_engine": beats}}
    log(f"[fleet] bf16, {len(timed)} requests, fleet of "
        f"{len(FLEET_REPLICAS)} against one engine on the same schedule: "
        f"{json.dumps(out['bf16'])} on {smi}")
    return out


def chaos_phase(params, want_prompts, want) -> dict:
    """(b) One replica die()s while it is mid-stream on an unfinished
    request (the victim as tests/test_fleet.py picks it), at f32: every
    request finishes against one engine's stream (phase 3b's tie rule),
    the victim alone is buried (heartbeat gauge -1.0) with at least one
    request requeued, and the cold_start callback's replacement, built
    by FleetReplica.from_live_params from the card's params, turns
    alive."""
    spawned = []

    def cold_start(_rid):
        spawned.append(fleet.add("r3"))

    fleet = _Fleet(params, None, rids=("rA", "rB"), cold_start=cold_start)
    router = fleet.router
    try:
        reqs = [router.submit(p, max_new_tokens=MAX_NEW)
                for p in want_prompts]
        victim, t_die, t_buried = None, None, None
        deadline = time.monotonic() + 300.0
        while router.has_work():
            if time.monotonic() > deadline:
                raise AssertionError("chaos: the fleet did not drain")
            router.step()
            if victim is None and any(
                    r.t_done is None and r.replica == "rA"
                    and len(r.generated) >= 1 for r in reqs):
                victim, t_die = "rA", time.perf_counter()
                fleet.replicas["rA"].die()
            if t_buried is None and router.failed_replicas:
                t_buried = time.perf_counter()
        if victim is None:
            raise AssertionError("chaos: the victim was never mid-stream")
        snap = router.fleet_snapshot()
        gauge = router.registry.gauge("fleet_replica_heartbeat_unix",
                                      {"replica": victim}).value
        if not (snap["failed_replicas"] == [victim]
                and snap["requeued_total"] >= 1 and gauge == -1.0
                and len(spawned) == 1):
            raise AssertionError(f"chaos: failed {snap['failed_replicas']}, "
                                 f"requeued {snap['requeued_total']}, "
                                 f"gauge {gauge}, spawned {len(spawned)}")
        for r in reqs:
            if not (r.finish_reason == "max_new_tokens"
                    and len(r.generated) == MAX_NEW):
                raise AssertionError(f"chaos: request {r.rid} ended "
                                     f"{r.finish_reason!r}")
        diverged = _fp_check_streams(params, "fleet chaos", want_prompts,
                                     want, reqs)
        fleet.wait_alive({"r3"})
        requeued = [r for r in reqs if r.requeues]
        out = {"victim": victim, "requeued_total": snap["requeued_total"],
               "failed_replicas": snap["failed_replicas"],
               "heartbeat_gauge": gauge,
               "die_to_burial_s": t_buried - t_die,
               "requeue_to_first_token_ms": [
                   (r.t_first_after_requeue - r.t_requeue) * 1e3
                   for r in requeued if r.t_first_after_requeue],
               "replacement_alive": True,
               "diverged_near_tie": diverged}
    finally:
        fleet.close()
    log(f"[fleet] chaos: {json.dumps(out)}")
    return out


def _drain(proc, lines: list, ready=None, marker=None) -> None:
    """Read a child's stdout to its end (a full pipe would block it),
    keeping the lines and setting ``ready`` at the first one holding
    ``marker``, or at the end."""
    for line in proc.stdout:
        lines.append(line)
        if marker is not None and marker in line:
            ready.set()
    if ready is not None:
        ready.set()


def fleet_cli_phase() -> dict:
    """(c) ``python -m deeplearning4j_tpu_torch.cli.driver fleet --replica
    --synthetic <flagship> --seed 0 --slots N_SLOTS --max-len MAX_LEN
    --serve-dtype none`` as a process on the card: it prints
    FLEET_REPLICA_READY, a router's FLEET_CLI_REQUESTS greedy requests
    (one at a time) equal an in-process engine's over the same seeded
    synthetic params (phase 3b's tie rule), and after finish() the
    process exits 0."""
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        StateTrackerClient,
        StateTrackerServer,
    )
    from deeplearning4j_tpu_torch.serve import FleetRouter
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine
    from deeplearning4j_tpu_torch.serve.fleet import synthetic_params
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    spec = f"{VOCAB},{D_MODEL},{N_HEADS},{N_EXPERTS},{D_FF},{N_LAYERS}"
    prompts = _fleet_prompts(45, FLEET_CLI_REQUESTS)
    server = StateTrackerServer()
    client = proc = None
    lines, ready = [], threading.Event()
    try:
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.cli.driver",
             "fleet", "--replica", "--tracker", server.address,
             "--synthetic", spec, "--seed", "0", "--slots", str(N_SLOTS),
             "--max-len", str(MAX_LEN), "--serve-dtype", "none",
             "--device", DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO)
        threading.Thread(target=_drain, daemon=True,
                         args=(proc, lines, ready,
                               "FLEET_REPLICA_READY")).start()
        ready.wait(180)
        ready_line = next((ln for ln in lines
                           if ln.startswith("FLEET_REPLICA_READY")), None)
        if ready_line is None:
            raise AssertionError("fleet CLI: no FLEET_REPLICA_READY:\n"
                                 + "".join(lines[-40:]))
        ready_s = time.perf_counter() - t0
        rid = ready_line.split()[1]
        client = StateTrackerClient(server.address)
        router = FleetRouter(client, registry=MetricsRegistry(),
                             stale_after_s=FLEET_STALE_S,
                             dead_after_s=FLEET_DEAD_S)
        got = []
        for p in prompts:
            req = router.submit(p, max_new_tokens=MAX_NEW)
            router.run_until_idle(timeout_s=120.0)
            got.append(req)
        sparams, h = synthetic_params(spec, 0)
        engine = DecodeEngine.from_live_params(
            sparams, h, device=DEVICE, **_engine_kwargs(None, 0))
        want = [engine.generate(p, max_new_tokens=MAX_NEW) for p in prompts]
        diverged = _fp_check_streams(engine.params, "fleet CLI", prompts,
                                     want, got)
        client.finish()
        rc = proc.wait(timeout=60)
        if rc != 0 or {r.replica for r in got} != {rid}:
            raise AssertionError(f"fleet CLI: exit {rc}:\n"
                                 + "".join(lines[-40:]))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        if client is not None:
            client.close()
        server.shutdown()
    out = {"replica": rid, "ready_s": ready_s, "requests": len(got),
           "diverged_near_tie": diverged, "exit": rc}
    log(f"[fleet] cli: {json.dumps(out)}")
    return out


def dist_performer(device=None):
    """The MNIST MLP's performer at the bench's width (phase 12's): the
    conf's initial params drawn on the CPU and put in through update().
    Phase 13's worker process resolves it as ``chip_smoke:dist_performer``
    (the worker CLI passes ``device=``)."""
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.scaleout.perform import (
        MultiLayerNetworkWorkPerformer,
    )

    conf = mnist_mlp(MLP_H1, MLP_H2)
    performer = MultiLayerNetworkWorkPerformer(conf.to_json(), device=device)
    performer.update(MultiLayerNetwork(conf, device="cpu").init()
                     .params().numpy())
    return performer


def distributed_phase(runner_samples_per_s) -> dict:
    """(d) DistributedMaster over TCP with DIST_WORKERS in-process
    DistributedWorker threads, each a MultiLayerNetworkWorkPerformer on
    the card: DIST_JOBS batch-512 synthetic_mnist jobs; K1 exactly 2 x
    iterations x jobs, the score falls, and each aggregation against the
    CPU's average of the same jobs from the same incoming params
    (_hold_round). Then DIST_PROC_JOBS jobs through one worker process
    (worker_main, ``--performer chip_smoke:dist_performer``) that finishes
    them and exits 0. Samples/s beside phase 12's LocalDistributedRunner."""
    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterator import (
        ListDataSetIterator,
    )
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.scaleout.distributed_runner import (
        DistributedMaster,
        DistributedWorker,
    )
    from deeplearning4j_tpu_torch.scaleout.job import DataSetJobIterator

    b = MLP_BATCH
    x, y = _mnist(b * (DIST_JOBS + DIST_PROC_JOBS), seed=53)
    conf = mnist_mlp(MLP_H1, MLP_H2)
    iters = conf.conf(0).num_iterations
    records = []

    def performer():
        perf = dist_performer(DEVICE)
        perform = perf.perform

        def recording(job):
            incoming = perf._params
            perform(job)
            records.append((incoming, job.work, job.result, job.score))

        perf.perform = recording
        return perf

    def jobs(lo, n):
        return DataSetJobIterator(ListDataSetIterator(
            DataSet(x[lo * b:(lo + n) * b], y[lo * b:(lo + n) * b]), b))

    master = DistributedMaster(job_iterator=jobs(0, DIST_JOBS),
                               min_workers=DIST_WORKERS,
                               max_rounds=DIST_JOBS, worker_timeout_s=60.0)
    aggregations = []
    update = master.router.update

    def recording_update(updates=None):
        snap = master.tracker.updates() if updates is None else updates
        results = [job.result for job in snap.values()]
        update(updates)
        aggregations.append((results, master.tracker.get_current()))

    master.router.update = recording_update
    workers = [DistributedWorker(master.address, performer(),
                                 worker_id=f"w{i}")
               for i in range(DIST_WORKERS)]
    threads = [threading.Thread(target=w.run, daemon=True) for w in workers]
    try:
        sync()
        _kernels.reset_launches()
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        final = master.train()
        for t in threads:
            t.join(timeout=60)
        sync()
        wall = time.perf_counter() - t0
        launches = _kernels.LAUNCHES["fused_dense"]
        done = master.tracker.count("jobs_done")
    finally:
        master.shutdown()
    if any(t.is_alive() for t in threads) or final is None \
            or done != DIST_JOBS or len(records) != DIST_JOBS:
        raise AssertionError(f"distributed: {done} jobs done, "
                             f"{len(records)} performed")
    if launches != 2 * iters * DIST_JOBS:
        raise AssertionError(f"distributed: fused_dense launched {launches} "
                             f"times, expected 2 x {iters} x {DIST_JOBS}")
    scores = [rec[3] for rec in records]
    first, last = np.mean(scores[:2]), np.mean(scores[-2:])
    if not last < first:
        raise AssertionError(f"distributed: score {first} -> {last}")
    # each aggregation against the CPU's average of the same jobs
    shape_net = MultiLayerNetwork(conf, device="cpu").init()

    def leaves(flat):
        shape_net.set_params(flat)
        return [a.numpy().copy() for a in tree_leaves(shape_net.params_tree)]

    errs, kinks = [], []
    for r, (results, current) in enumerate(aggregations):
        cpu, starts = [], []
        for res in results:
            incoming, work, _, _ = next(
                rec for rec in records if np.array_equal(rec[2], res))
            net = MultiLayerNetwork(conf, device="cpu").init()
            net.set_params(incoming)
            net.fit(work)
            cpu.append(net.params().numpy())
            starts.append(incoming)
        _hold_round("distributed", r, leaves(current),
                    leaves(np.mean(cpu, axis=0)),
                    leaves(np.mean(starts, axis=0)), errs, kinks)
    out = {"jobs": DIST_JOBS, "workers": DIST_WORKERS,
           "aggregations": len(aggregations), "wall_s": wall,
           "samples_per_s": b * DIST_JOBS / wall, "launches": launches,
           "first_scores": first, "last_scores": last,
           "max_leaf_rel_err_vs_cpu": max(errs),
           "leaves_over_runner_tol": kinks,
           "local_runner_samples_per_s": runner_samples_per_s}

    # one worker as a process through worker_main
    master = DistributedMaster(job_iterator=jobs(DIST_JOBS, DIST_PROC_JOBS),
                               min_workers=1, max_rounds=DIST_PROC_JOBS,
                               register_timeout_s=180.0,
                               worker_timeout_s=60.0)
    proc = None
    lines = []
    try:
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "deeplearning4j_tpu_torch.scaleout.distributed_runner",
             "--connect", master.address,
             "--performer", "chip_smoke:dist_performer",
             "--worker-id", "p0", "--device", DEVICE],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO)
        threading.Thread(target=_drain, daemon=True,
                         args=(proc, lines)).start()
        t0 = time.perf_counter()
        master.train()
        rc = proc.wait(timeout=60)
        pwall = time.perf_counter() - t0
        pdone = master.tracker.count("jobs_done")
        prounds = master.tracker.count("rounds.p0")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        master.shutdown()
    if rc != 0 or pdone != DIST_PROC_JOBS or prounds != DIST_PROC_JOBS:
        raise AssertionError(f"worker process: exit {rc}, {pdone} jobs, "
                             f"{prounds} rounds:\n" + "".join(lines[-40:]))
    out["process"] = {"jobs": DIST_PROC_JOBS, "exit": rc,
                      "wall_s_from_register_wait": pwall}
    log(f"[distributed] {json.dumps(out)}")
    return out


def slice4c(smi: str, runner_samples_per_s) -> dict:
    """Phase 13: the serving fleet (FleetRouter over FleetReplicas, K3f in
    each replica's prefills), its chaos run and its CLI process, and the
    DistributedMaster with its workers over the wire (K1 in every job)."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params
    from deeplearning4j_tpu_torch.serve.engine import DecodeEngine

    t0 = time.perf_counter()
    # phase 3's flagship params, drawn again from the same seed
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    # the f32 oracle: one engine, one request at a time
    prompts = _fleet_prompts(41, FLEET_REQUESTS)
    single = DecodeEngine(params, N_HEADS, device=DEVICE,
                          **_engine_kwargs(None, 0))
    want = [single.generate(p, max_new_tokens=MAX_NEW) for p in prompts]
    del single
    out = {"fleet": fleet_phase(params, prompts, want, smi),
           "chaos": chaos_phase(params, prompts, want)}
    del params
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    out["cli"] = fleet_cli_phase()
    out["distributed"] = distributed_phase(runner_samples_per_s)
    out["wall_s"] = time.perf_counter() - t0
    bf = out["fleet"]["bf16"]
    summary = {
        "fleet_tokens_per_s": bf["fleet"]["tokens_per_sec"],
        "one_engine_tokens_per_s": bf["one_engine"]["tokens_per_sec"],
        "fleet_latency_p50_p99_ms": [bf["fleet"]["latency_p50_ms"],
                                     bf["fleet"]["latency_p99_ms"]],
        "one_engine_latency_p50_p99_ms": [
            bf["one_engine"]["latency_p50_ms"],
            bf["one_engine"]["latency_p99_ms"]],
        "fleet_first_token_p50_p99_ms": [bf["fleet"]["first_token_p50_ms"],
                                         bf["fleet"]["first_token_p99_ms"]],
        "one_engine_first_token_p50_p99_ms": [
            bf["one_engine"]["first_token_p50_ms"],
            bf["one_engine"]["first_token_p99_ms"]],
        "fleet_busy_share": bf["fleet"]["profiled"]["busy_share"],
        "fleet_tracker_rpcs_per_token": bf["fleet"]["tracker_rpcs_per_token"],
        "fleet_beats_one_engine": bf["fleet_beats_one_engine"],
        "chaos_die_to_burial_s": out["chaos"]["die_to_burial_s"],
        "distributed_samples_per_s": out["distributed"]["samples_per_s"],
        "local_runner_samples_per_s": runner_samples_per_s,
        "wall_s": out["wall_s"]}
    log(f"[slice4c] {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------------------ phase 14 ----

# item 20a: the ring's kernel work over P shards in one process, the LM's
# composed step on a ("data", "sp", "expert") mesh and the staged LM on a
# ("data", "pipe") mesh, in a one-rank NCCL group (world size 1: the ring,
# the all-to-alls and the stage hops are one rank's)
RING_SHARDS = 4
COMPOSED_STEPS = 3
# the composed step against the single-device step from the same state.
# In float64 (dense attention: the kernels take f32 and bf16) they are
# one function: params of each leaf's max and losses within F64_TOL. At
# f32, the kernel path, the MoE dispatch (gather, expert products,
# scatter-add) sums in another order than the dense MoE: one step's grads
# differ by 2.3e-6 of a leaf's max, both 7.0e-3 from float64 on
# experts.w1, and three steps move params 2.4e-3 apart (on an H100);
# Adam's normalized steps move both f32 runs up to 0.21 of a bias leaf's max
# from float64 and their losses 1.2e-6 apart. So each f32 loss and
# each leaf's params are held to lie no farther from the float64 run than
# the single-device step's do, up to F32_SPREAD (plus COMPOSED_TOL of the
# loss).
F64_TOL = 1e-10
F32_SPREAD = 2.0
COMPOSED_TOL = DP_TOL
DROP_CAPACITY = 1024         # under the ~4096 routes an expert takes
MOE_REF_TOL = 1e-5
PP_MICRO, PP_STEPS = 4, 2
# the card's staged steps against the CPU's: each leaf within PP_TOL of
# its max, or no farther from the same steps in float64 than the CPU's
# are, up to F32_SPREAD (two f32 runs of the MoE FFN part by up to 3.2e-3
# of a zero-initialized bias's max in two steps on an H100); losses
# likewise
PP_TOL = 1e-5
PP_DENSE_WIDTH, PP_DENSE_ROWS = 1024, 512


def ring_phase() -> dict:
    """(a) ring_attention_in_process, the ring's per-rank body over
    RING_SHARDS shards of TRAIN_T / RING_SHARDS (the rotation a shift of
    the list), "blockwise" forced, causal, at the training shape in f32
    and bf16: the output and the grads of sum(o²) against the unsharded
    kernel route (attention_core "blockwise") at phase 2's tolerances,
    K3f, K3k and K3q each launched P(P+1)/2 times a call, prefetch=True
    and False bit-identical, device ms of the ring's pass beside the
    unsharded one's; then an unaligned block_partials offset raises."""
    import torch

    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel.ring_attention import \
        ring_attention_in_process

    b, h, t, dh = TRAIN_B, N_HEADS, TRAIN_T, D_MODEL // N_HEADS
    pairs = RING_SHARDS * (RING_SHARDS + 1) // 2
    out = {"shards": RING_SHARDS, "shard_len": t // RING_SHARDS,
           "shape": [b, h, t, dh]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        q, k, v = (x.requires_grad_() for x in _qkv((b, h, t, dh), dtype,
                                                     seed=41))

        def ring(prefetch=True):
            o = ring_attention_in_process(q, k, v, RING_SHARDS, causal=True,
                                          attn_impl="blockwise",
                                          prefetch=prefetch)
            return o, torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))

        def whole():
            o = fa.attention_core(q, k, v, causal=True, impl="blockwise")
            return o, torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))

        ref_o, ref_g = whole()
        _kernels.reset_launches()
        o, grads = ring()
        sync()
        launches = {n: _kernels.LAUNCHES[n] for n in TRAIN_KERNELS}
        if launches != dict.fromkeys(TRAIN_KERNELS, pairs):
            raise AssertionError(f"ring over {RING_SHARDS} shards launched "
                                 f"{launches}, expected {pairs} each")
        o2, grads2 = ring(prefetch=False)
        if not (torch.equal(o, o2) and all(
                torch.equal(a, c) for a, c in zip(grads, grads2))):
            raise AssertionError("ring: prefetch=True and False differ")
        err_o = (o.float() - ref_o.float()).abs().max().item()
        err_g = max(_rel_err(g, r) for g, r in zip(grads, ref_g))
        run = {"launches": launches, "o_err": err_o, "grad_rel_err": err_g,
               "finite": bool(torch.isfinite(o.float()).all().item())}
        if (err_o > TOL[name]["o"] or err_g > BWD_TOL[name]
                or not run["finite"]):
            raise AssertionError(f"ring against the unsharded kernels "
                                 f"({name}): {run}")
        if DEVICE == "cuda":
            run["ring_ms"] = device_ms(ring, reps=10)
            run["unsharded_ms"] = device_ms(whole, reps=10)
        out[name] = run
        del q, k, v, o, o2, grads, grads2, ref_o, ref_g
    qa = torch.zeros((1, 1, 64, dh), device=DEVICE)
    try:
        fa.blockwise_block_partials(qa, qa, qa, 64, 32, causal=True)
        out["unaligned_raise"] = None
    except ValueError as e:
        out["unaligned_raise"] = str(e)
    if DEVICE == "cuda" and out["unaligned_raise"] is None:
        raise AssertionError("an unaligned block_partials offset ran on the "
                             "card")
    log(f"[ring] {json.dumps(out)}")
    return out


def _composed_collectives(steps: int, metrics: bool) -> dict:
    """What composed steps on the one-rank ("data", "sp", "expert") mesh
    issue with the all-to-all dispatch: per layer the dispatch's two
    all-to-alls forward and two backward, its output gather and the
    split's backward gather, and the router grads' all-reduce; per step
    the statistics and the grads all-reduces (and the metrics' two
    norms, each one all-reduce over "expert")."""
    return {"all_reduce": steps * (2 + N_LAYERS + (2 if metrics else 0)),
            "all_gather": steps * 2 * N_LAYERS,
            "all_to_all": steps * 4 * N_LAYERS,
            "send_recv": 0, "broadcast": 0}


def _leaf_errs(got, want) -> dict:
    """Each leaf's max abs error over ``want``'s leaf max, by key path."""
    from deeplearning4j_tpu_torch._device import tree_leaves, tree_paths

    return {".".join(map(str, p)): float(
        (a.double() - b.double()).abs().max()
        / b.double().abs().max().clamp_min(1e-300))
        for p, a, b in zip(tree_paths(want), tree_leaves(got),
                           tree_leaves(want))}


def composed_phase(mesh, single_ms: float, dp_ms: float) -> dict:
    """(b) make_composed_train_step on the one-rank ("data", "sp",
    "expert") mesh at the flagship's full width and training shape, ample
    capacity ((B/dp)·T), COMPOSED_STEPS SGD and Adam steps against
    make_single_device_train_step from the same state: in float64 with
    dense attention the same function (F64_TOL); at f32 through the
    kernels, each loss and each leaf's params no farther from the float64
    run than the single-device step's (F32_SPREAD); at
    DROP_CAPACITY with metrics: each step's moe_dropped_frac equal to
    expected_dropped over the routes, counted on the host from the same
    activations, layer 0's moe_apply equal to moe_reference on them, the
    loss finite and falling; K3f, K3k, K3q exactly n_layers x steps and
    the collectives exactly as derived (``_composed_collectives``); ms a
    step and tokens/s beside phase 4's single-device and phase 12's
    ("data",) step."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_map
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import moe

    params, tokens, targets = _train_setup(seed=3)
    tk, tg = T.shard_lm_batch(tokens, targets, mesh, device=DEVICE)
    ample = (TRAIN_B // mesh.shape["data"]) * TRAIN_T
    token_axes = ("data", "sp")

    def clone(tree, dtype=None):
        return tree_map(lambda _, a: a.clone().to(dtype or a.dtype), tree)

    def run(opt, dtype, composed, attn_impl=None):
        p = clone(params, dtype)
        if composed:
            step = T.make_composed_train_step(
                mesh, N_HEADS, ample, optimizer=opt, attn_impl=attn_impl,
                device=DEVICE)
            p = T.shard_lm_params(p, mesh, device=DEVICE)
            batch = (tk, tg)
        else:
            step = T.make_single_device_train_step(
                N_HEADS, optimizer=opt, attn_impl=attn_impl, device=DEVICE)
            batch = (tokens, targets)
        carry = (p,) if opt is None else (
            p, T.init_lm_opt_state(opt, p, mesh if composed else None,
                                   device=DEVICE))
        return step, carry, batch

    out = {"mesh": dict(mesh.shape), "capacity": ample,
           "moe_impl": T.selected_moe_impl(mesh, TRAIN_B * TRAIN_T)}
    for mode in ("sgd", "adam"):
        opt = None if mode == "sgd" else OptimizerConfig(name="adam",
                                                         lr=ADAM_LR)
        # float64, dense attention: one function
        c64 = {}
        for composed in (False, True):
            step, carry, batch = run(opt, torch.float64, composed, "dense")
            c64[composed] = _timed_steps(step, carry, batch,
                                         COMPOSED_STEPS)[:2]
        f64_err = max(_leaf_errs(c64[True][0][0], c64[False][0][0])
                      .values())
        f64_loss = max(abs(a - b) / abs(b) for a, b in
                       zip(c64[True][1], c64[False][1]))
        want64, loss64 = c64[False][0][0], c64[False][1]
        del c64
        # f32 through the kernels
        step, carry, batch = run(opt, None, False)
        single, l1, _ = _timed_steps(step, carry, batch, COMPOSED_STEPS)
        step, carry, batch = run(opt, None, True)
        _kernels.reset_launches()
        pmesh.reset_collectives()
        c2, l2, _ = _timed_steps(step, carry, batch, COMPOSED_STEPS)
        launches = _check_launches(f"composed {mode}", COMPOSED_STEPS)
        coll = dict(pmesh.COLLECTIVES)
        want = _composed_collectives(COMPOSED_STEPS, False)
        if coll != want:
            raise AssertionError(f"composed {mode}: collectives {coll}, "
                                 f"expected {want}")
        e_single = _leaf_errs(single[0], want64)
        e_comp = _leaf_errs(c2[0], want64)
        spread = {k: e_comp[k] / max(e_single[k], 1e-12) for k in e_comp}
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(l2, l1))
        # each step's loss no farther from the float64 run's than the
        # single-device step's
        loss_bad = [i for i, (a, b, w) in enumerate(zip(l2, l1, loss64))
                    if abs(a - w) > F32_SPREAD * abs(b - w)
                    + COMPOSED_TOL * abs(w)]
        run_ = {"f64_max_leaf_rel_err": f64_err, "f64_max_loss_rel_err":
                f64_loss, "max_loss_rel_err": loss_err, "losses": l2,
                "single_losses": l1, "f64_losses": loss64,
                "max_leaf_rel_err_vs_single": max(_leaf_errs(
                    c2[0], single[0]).values()),
                "leaf_rel_err_vs_f64": {k: [e_single[k], e_comp[k]]
                                        for k in e_comp},
                "launches": {k: launches[k] for k in TRAIN_KERNELS},
                "collectives": coll}
        bad = [k for k in e_comp
               if e_comp[k] > F32_SPREAD * e_single[k] + COMPOSED_TOL]
        if (f64_err > F64_TOL or f64_loss > F64_TOL or bad or loss_bad
                or not l2[-1] < l2[0]):
            raise AssertionError(f"composed {mode} against the single-"
                                 f"device step (leaves over the spread: "
                                 f"{bad}, {spread}; steps {loss_bad}): "
                                 f"{run_}")
        c2, _, ms = _timed_steps(step, c2, batch, DP_TIMED)
        run_.update({"ms_per_step": ms,
                     "tokens_per_s": TRAIN_B * TRAIN_T * 1e3 / ms})
        out[mode] = run_
        del step, single, c2, want64

    # a capacity that drops routes, with the metrics block
    comp = T.make_composed_train_step(mesh, N_HEADS, DROP_CAPACITY,
                                      with_metrics=True, device=DEVICE)
    p = T.shard_lm_params(clone(params), mesh, device=DEVICE)
    shards = moe.route_shards(mesh, token_axes, "expert", TRAIN_B * TRAIN_T)
    states, losses, fracs = [], [], []
    _kernels.reset_launches()
    pmesh.reset_collectives()
    for _ in range(COMPOSED_STEPS):
        states.append(clone(p))
        p, loss, metrics = comp(p, tk, tg)
        losses.append(float(loss))
        fracs.append(float(metrics["moe_dropped_frac"]))
    launches = _check_launches("composed with drops", COMPOSED_STEPS)
    coll = dict(pmesh.COLLECTIVES)
    want = _composed_collectives(COMPOSED_STEPS, True)
    if coll != want:
        raise AssertionError(f"composed with drops: collectives {coll}, "
                             f"expected {want}")
    # the host's count: each step's forward again from its incoming
    # params, the dispatch's activations kept
    host, ref_err = [], None
    with torch.no_grad():
        for s in states:
            routed = []

            def moe_fn(rw, ex, x, routed=routed):
                routed.append(x)
                return moe.moe_apply(rw, ex, x, mesh, T.expert_fn,
                                     DROP_CAPACITY, top_k=2,
                                     token_axes=token_axes)

            T.lm_forward(s, tk, N_HEADS, lambda q, k, v: T.attention_core(
                q, k, v, causal=True), moe_fn)
            routers = s["blocks"]["router"]
            host.append(float(np.mean([
                moe.expected_dropped(routers[i], x, DROP_CAPACITY, 2,
                                     n_shards=shards)
                for i, x in enumerate(routed)])) / (TRAIN_B * TRAIN_T * 2))
            if ref_err is None:
                layer = T._layer(s["blocks"], 0)
                got = moe.moe_apply(layer["router"], layer["experts"],
                                    routed[0], mesh, T.expert_fn,
                                    DROP_CAPACITY, top_k=2,
                                    token_axes=token_axes)
                per = [tree_map(lambda _, a, e=e: a[e], layer["experts"])
                       for e in range(N_EXPERTS)]
                ref = moe.moe_reference(layer["router"], per, routed[0],
                                        T.expert_fn, DROP_CAPACITY, 2,
                                        shards)
                ref_err = (got.float() - ref).abs().max().item()
    drop_err = max(abs(a - b) for a, b in zip(fracs, host))
    drops = {"capacity": DROP_CAPACITY, "losses": losses,
             "moe_dropped_frac": fracs, "host_dropped_frac": host,
             "max_dropped_frac_err": drop_err, "moe_reference_err": ref_err,
             "launches": {k: launches[k] for k in TRAIN_KERNELS},
             "collectives": coll}
    if (drop_err > 1e-6 or ref_err > MOE_REF_TOL or min(fracs) <= 0
            or not all(np.isfinite(losses)) or not losses[-1] < losses[0]):
        raise AssertionError(f"composed step with drops: {drops}")
    out["drops"] = drops
    out["single_device_ms_per_step"] = single_ms
    out["dp_ms_per_step"] = dp_ms
    log(f"[composed] {json.dumps(out)}")
    return out


def _pp_steps(mesh, params, toks, tgts, overlap: bool, device,
              dtype=None, attn_impl=None) -> tuple:
    """PP_STEPS SGD steps (lr 0.1) of the staged flagship through
    make_pp_loss on ``mesh`` (params cast to ``dtype`` where given):
    (losses, params, ms a step)."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map, \
        tree_unflatten
    from deeplearning4j_tpu_torch.models import transformer_lm as T

    params = tree_map(lambda _, a: a.detach().to(device, dtype).clone(),
                      params)
    trained, stage_fn = T.lm_params_to_pp_trained(
        params, mesh, N_HEADS, mesh.shape["pipe"], attn_impl=attn_impl)
    loss_fn = T.make_pp_loss(stage_fn, mesh, "pipe", batch_axis="data",
                             overlap=overlap)
    toks, tgts = toks.to(device), tgts.to(device)
    losses = []
    if device != "cpu":
        sync()
    t0 = time.perf_counter()
    for _ in range(PP_STEPS):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(trained)]
        loss = loss_fn(tree_unflatten(trained, leaves), toks, tgts)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            trained = tree_unflatten(trained, [
                p - 0.1 * g for p, g in zip(leaves, grads)])
        losses.append(loss.detach())
    if device != "cpu":
        sync()
    ms = (time.perf_counter() - t0) * 1e3 / PP_STEPS
    return ([float(x) for x in losses], T.pp_trained_to_lm_params(trained),
            ms)


def pp_reference() -> tuple:
    """The staged flagship's PP_STEPS steps on the CPU (no process group:
    a mesh of one rank whose collectives are the identity), from the
    state phase (c) starts from."""
    from deeplearning4j_tpu_torch.parallel.mesh import Mesh

    params, tokens, _ = _train_setup(seed=4)
    toks = np.random.RandomState(6).randint(0, VOCAB, (PP_MICRO, 1,
                                                       TRAIN_T + 1))
    import torch

    toks = torch.as_tensor(toks)
    cpu = Mesh(("data", "pipe"), (1, 1))
    losses, trained, ms = _pp_steps(cpu, params, toks[..., :-1],
                                    toks[..., 1:], False, "cpu")
    return params, toks, losses, trained, ms


def pp_phase(mesh, ref, single_ms: float) -> dict:
    """(c) the staged flagship on the one-rank ("data", "pipe") mesh:
    make_pp_stages(n_stages=1) and make_pp_loss over PP_MICRO
    microbatches of one TRAIN_T-token sequence, PP_STEPS SGD steps strict
    and overlap=True: the two bit-identical, losses and params within
    PP_TOL of each leaf's max of the same steps on the CPU, K3f, K3k, K3q
    exactly n_layers x microbatches a step; then pipeline_from_conf on a
    uniform 1024→1024 tanh dense layer, PP_MICRO microbatches of 512 rows:
    K1 once a microbatch, the output the layer's dense.forward."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.nn import functional as NF
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.layers import dense
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        pipeline_apply,
        pipeline_from_conf,
    )

    params, toks, cpu_losses, cpu_trained, cpu_ms = ref
    out = {"mesh": dict(mesh.shape), "microbatches": PP_MICRO,
           "cpu_ms_per_step": cpu_ms, "cpu_losses": cpu_losses}
    runs = {}
    for overlap in (False, True):
        _kernels.reset_launches()
        pmesh.reset_collectives()
        losses, trained, ms = _pp_steps(mesh, params, toks[..., :-1],
                                        toks[..., 1:], overlap, DEVICE)
        launches = {n: _kernels.LAUNCHES[n] for n in TRAIN_KERNELS}
        want = N_LAYERS * PP_MICRO * PP_STEPS
        if launches != dict.fromkeys(TRAIN_KERNELS, want):
            raise AssertionError(f"pp overlap={overlap}: launches "
                                 f"{launches}, expected {want} each")
        runs[overlap] = (losses, trained)
        out["overlap" if overlap else "strict"] = {
            "losses": losses, "ms_per_step": ms,
            "tokens_per_s": PP_MICRO * TRAIN_T * 1e3 / ms,
            "launches": launches, "collectives": dict(pmesh.COLLECTIVES)}
    (l0, t0), (l1, t1) = runs[False], runs[True]
    if l0 != l1 or not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(t0), tree_leaves(t1))):
        raise AssertionError("pp: the overlap schedule differs from the "
                             "strict one")
    # the same steps in float64 (dense attention) on the card: the truth
    # both f32 runs are held against
    l64, t64, _ = _pp_steps(mesh, params, toks[..., :-1], toks[..., 1:],
                            False, DEVICE, torch.float64, "dense")
    t64 = tree_map_cpu(t64)
    card = tree_map_cpu(t0)
    errs = _leaf_errs(card, cpu_trained)
    e_card, e_cpu = _leaf_errs(card, t64), _leaf_errs(cpu_trained, t64)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(l0, cpu_losses))
    bad = [k for k in errs if errs[k] > PP_TOL
           and e_card[k] > F32_SPREAD * e_cpu[k] + PP_TOL]
    loss_bad = [i for i, (a, b, w) in enumerate(zip(l0, cpu_losses, l64))
                if abs(a - b) > PP_TOL * abs(b)
                and abs(a - w) > F32_SPREAD * abs(b - w) + PP_TOL * abs(w)]
    out.update({"max_leaf_rel_err_vs_cpu": max(errs.values()),
                "leaf_rel_err_vs_cpu": errs,
                "leaf_rel_err_vs_f64": {k: [e_cpu[k], e_card[k]]
                                        for k in errs},
                "max_loss_rel_err_vs_cpu": loss_err, "f64_losses": l64,
                "single_device_ms_per_step": single_ms})
    if bad or loss_bad or not all(np.isfinite(l0)):
        raise AssertionError(f"pp against the CPU (leaves {bad}, steps "
                             f"{loss_bad}): {out}")

    conf = (NeuralNetConfiguration.Builder()
            .n_in(PP_DENSE_WIDTH).n_out(PP_DENSE_WIDTH)
            .activation_function("tanh").seed(3).list(2)
            .override(1, layer_type="OUTPUT", n_in=PP_DENSE_WIDTH, n_out=10,
                      activation_function="softmax", loss_function="MCXENT")
            .pretrain(False).backward(True).build())
    net_params = NF.init_params(conf, 0, device=DEVICE)
    stage, stage_fn = pipeline_from_conf(conf, net_params, mesh)
    x = torch.randn(PP_MICRO, PP_DENSE_ROWS, PP_DENSE_WIDTH,
                    generator=torch.Generator(device=DEVICE).manual_seed(8),
                    device=DEVICE)
    _kernels.reset_launches()
    with torch.no_grad():
        y = pipeline_apply(stage, x, stage_fn, mesh)
    k1 = _kernels.LAUNCHES["fused_dense"]
    with torch.no_grad():
        want = torch.stack([dense.forward(conf.conf(0), net_params[0], m)
                            for m in x])
    dense_err = (y - want).abs().max().item()
    out["dense"] = {"shape": [PP_MICRO, PP_DENSE_ROWS, PP_DENSE_WIDTH],
                    "k1_launches": k1, "max_abs_err": dense_err}
    if k1 != PP_MICRO or dense_err > 0:
        raise AssertionError(f"pipeline_from_conf: {out['dense']}")
    log(f"[pp] {json.dumps(out)}")
    return out


def tree_map_cpu(tree):
    from deeplearning4j_tpu_torch._device import tree_map

    return tree_map(lambda _, a: a.detach().cpu(), tree)


def slice20a(smi: str, single_ms: float, dp_ms: float) -> dict:
    """Phase 14: item 20a. (a) the ring's kernel work over RING_SHARDS
    shards on the card; then, in a one-rank NCCL group, (b) the composed
    step on ("data", "sp", "expert") and (c) the staged LM and
    pipeline_from_conf on ("data", "pipe"), against the CPU's staged
    steps computed first (no group)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    out = {"ring": ring_phase()}
    ref = pp_reference()
    out["pp_cpu_reference_s"] = time.perf_counter() - t0
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        backend = dist.get_backend()
        if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
            raise AssertionError(f"process group backend {backend}")
        out["composed"] = composed_phase(
            pmesh.Mesh(("data", "sp", "expert"), (1, 1, 1)), single_ms,
            dp_ms)
        out["pp"] = pp_phase(pmesh.Mesh(("data", "pipe"), (1, 1)), ref,
                             single_ms)
    finally:
        multihost.shutdown()
    out["wall_s"] = time.perf_counter() - t0
    c, p, r = out["composed"], out["pp"], out["ring"]
    summary = {
        "ring_ms": {k: r[k].get("ring_ms") for k in ("float32", "bfloat16")},
        "unsharded_ms": {k: r[k].get("unsharded_ms")
                         for k in ("float32", "bfloat16")},
        "composed_sgd_ms_per_step": c["sgd"]["ms_per_step"],
        "composed_adam_ms_per_step": c["adam"]["ms_per_step"],
        "composed_tokens_per_s": c["sgd"]["tokens_per_s"],
        "single_device_ms_per_step": single_ms,
        "dp_ms_per_step": dp_ms,
        "pp_ms_per_step": p["strict"]["ms_per_step"],
        "pp_overlap_ms_per_step": p["overlap"]["ms_per_step"],
        "composed_collectives_a_step": {
            k: v // COMPOSED_STEPS for k, v in
            c["sgd"]["collectives"].items()},
        "wall_s": out["wall_s"]}
    log(f"[slice20a] {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------------------ phase 15 ----

# items 20b and 20c: tensor parallelism at full width, every coordinate's
# kernel work on the one card; the TP and composed steps on a one-rank
# NCCL ("data", "model") mesh; checkpoints of the flagship's trained state
# through the multi-process writer and the async writer; the guard
TP_MLP_DEGREE = 2
TP_ATTN_DEGREES = (2, 4)
TP_STEPS_TIMED = 5
GUARD_STEPS = 2          # healthy steps before the poisoned batch
ROLLBACK_TOL = 1e-6      # resumed steps against the unpoisoned run
CKPT_TRAIN_STEPS = 3     # Adam steps behind the saved state
ASYNC_OVERLAP_STEPS = 5


class _OneCoordinate:
    """One "model" rank's work alone, for its time: the collectives are
    left out (f and g pass the rank's value on, a gather tiles its
    columns to the full width), so the interval holds the coordinate's
    kernels and local products only."""

    def __init__(self, tp: int, rank: int):
        self.tp, self.ranks = tp, (rank,)

    def fan_out(self, x):
        return [x]

    def reduce(self, parts):
        return parts[0]

    def gather(self, parts):
        import torch

        return torch.cat([parts[0]] * self.tp, dim=-1)

    def split(self, x):
        n = x.shape[-1] // self.tp
        r = self.ranks[0]
        return [x[..., r * n:(r + 1) * n]]


def _tp_fake_mesh(tp: int, rank: int):
    import types

    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": tp},
                                 coords={"data": 0, "model": rank})


def _assembled_grads(grads, specs, per_rank_n, tp):
    """Each param's whole grad from the coordinates' shard grads:
    concatenated on the split dim, rank 0's for a replicated leaf."""
    import torch

    out = []
    at = 0
    for spec in specs:
        if spec:
            dim = [d for d, e in enumerate(spec) if e][0]
            out.append(torch.cat([grads[r * per_rank_n + at]
                                  for r in range(tp)], dim))
        else:
            out.append(grads[at])
        at += 1
    return out


def tp_coordinates(name, conf, x, y, tp, loss_tol, grad_tol,
                   want_launches) -> dict:
    """One step's loss and grads of ``conf`` with every coordinate of a
    (1, tp) ("data", "model") mesh placed by ``apply_shardings`` and run
    in this process (``tensor_parallel.tp_loss_in_process``: partials
    summed and columns concatenated on the card where the collectives
    would), against the unsharded step on the card at f32 (TF32 off):
    loss within ``loss_tol``, each grad within ``grad_tol`` of its max;
    kernel launches exactly ``want_launches``. Times the whole in-process
    step, each coordinate's work alone, and the single-device step."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_unflatten
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.ops import _kernels
    from deeplearning4j_tpu_torch.parallel import sharding
    from deeplearning4j_tpu_torch.parallel import tensor_parallel as TP

    params = F.init_params(conf, 3, device=DEVICE)
    specs = sharding.param_shardings(conf, _tp_fake_mesh(tp, 0))
    flat_specs = [tuple(specs[i].get(k, ())) for i, layer in
                  enumerate(params) for k in sorted(layer)]
    per_rank = [sharding.apply_shardings(params, specs,
                                         _tp_fake_mesh(tp, r))
                for r in range(tp)]
    head = conf.conf(conf.n_layers - 1).loss_function

    def tp_step():
        leaves = [[p.detach().requires_grad_() for p in tree_leaves(pr)]
                  for pr in per_rank]
        trees = [tree_unflatten(pr, lv) for pr, lv in zip(per_rank, leaves)]
        loss = TP.tp_loss_in_process(conf, trees, x, y)
        return loss, torch.autograd.grad(
            loss, [p for lv in leaves for p in lv], allow_unused=True,
            materialize_grads=True)

    def single_step():
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss = F.network_loss(conf, tree_unflatten(params, leaves), x, y,
                              train=True)
        return loss, torch.autograd.grad(loss, leaves)

    def coordinate_step(r):
        comm = _OneCoordinate(tp, r)
        leaves = [p.detach().requires_grad_() for p in
                  tree_leaves(per_rank[r])]
        per = TP.tp_per_example_loss(
            conf, [tree_unflatten(per_rank[r], leaves)], x, y, comm,
            specs=specs, train=True)
        from deeplearning4j_tpu_torch.ops.losses import finalize_loss

        return torch.autograd.grad(finalize_loss(head, per.mean()), leaves,
                                   allow_unused=True, materialize_grads=True)

    _kernels.reset_launches()
    loss, grads = tp_step()
    sync()
    launches = {k: _kernels.LAUNCHES[k] for k in want_launches}
    ref_loss, ref_grads = single_step()
    got = _assembled_grads(grads, flat_specs, len(flat_specs), tp)
    names = [f"{i}.{k}" for i, layer in enumerate(params)
             for k in sorted(layer)]
    errs = {n: _rel_err(g, w) for n, g, w in zip(names, got, ref_grads)}
    loss, ref_loss = float(loss.detach()), float(ref_loss.detach())
    loss_err = abs(loss - ref_loss)
    out = {"tp": tp, "loss": loss, "loss_err": loss_err,
           "grad_rel_err": errs, "launches": launches,
           "sharded": [n for n, s in zip(names, flat_specs) if s]}
    if (not loss_err <= loss_tol or not max(errs.values()) <= grad_tol
            or launches != want_launches
            or not all(bool(torch.isfinite(g).all())
                       for g in list(got) + list(ref_grads))):
        raise AssertionError(f"[tp] {name} at tp {tp} against the "
                             f"unsharded step: {out}, expected launches "
                             f"{want_launches}")
    if DEVICE == "cuda":
        out["ms_per_step"] = time_ms(tp_step, reps=TP_STEPS_TIMED)
        out["single_device_ms_per_step"] = time_ms(single_step,
                                                   reps=TP_STEPS_TIMED)
        out["coordinate_ms_per_step"] = [
            time_ms(lambda r=r: coordinate_step(r), reps=TP_STEPS_TIMED)
            for r in range(tp)]
    log(f"[tp] {name} {json.dumps(out)}")
    return out


def tp_one_rank(mesh, mlp_x, mlp_y, attn_x, attn_y) -> dict:
    """(b) ``make_tp_train_step`` on the one-rank ("data", "model") mesh
    shards nothing: two steps equal ``make_train_step``'s bit for bit
    (scores, params, updater state), for the MNIST MLP and the attention
    char-LM. Then the composed LM step on ("data", "model") (1, 1)
    against phase 12's ("data",) step: two SGD steps, bit for bit."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import \
        make_tp_train_step

    def bits(a, b):
        return all(torch.equal(p, q) for p, q in
                   zip(tree_leaves(a), tree_leaves(b)))

    out = {}
    for name, conf, x, y in (("mlp", mnist_mlp(MLP_H1, MLP_H2), mlp_x,
                              mlp_y),
                             ("attn", _attn_conf(), attn_x, attn_y)):
        params = F.init_params(conf, 5, device=DEVICE)
        runs = []
        for step in (make_tp_train_step(conf, mesh), F.make_train_step(conf)):
            p = tree_map(lambda _, a: a.clone(), params)
            st = F.init_train_state(conf, p)
            scores = []
            for i in range(2):
                p, st, score = step(p, st, i, x, y, 7 + i)
                scores.append(float(score))
            runs.append((p, st, scores))
        equal = bits(runs[0][0], runs[1][0]) and bits(runs[0][1], runs[1][1]) \
            and runs[0][2] == runs[1][2]
        out[name] = {"bitwise_equal": equal, "scores": runs[0][2]}
        if not equal:
            raise AssertionError(f"TP step on a (1, 1) mesh against "
                                 f"make_train_step ({name}): not bitwise "
                                 f"equal, scores {runs[0][2]} vs "
                                 f"{runs[1][2]}")
    params, tokens, targets = _train_setup()
    dm = pmesh.Mesh(("data",), (1,))
    runs = []
    for m in (mesh, dm):
        step = T.make_composed_train_step(m, N_HEADS, 0, device=DEVICE)
        p = T.shard_lm_params(tree_map(lambda _, a: a.clone(), params), m,
                              device=DEVICE)
        tk, tg = T.shard_lm_batch(tokens, targets, m, device=DEVICE)
        losses = []
        for _ in range(2):
            p, loss = step(p, tk, tg)
            losses.append(float(loss))
        runs.append((p, losses))
    equal = bits(runs[0][0], runs[1][0]) and runs[0][1] == runs[1][1]
    out["composed_data_model"] = {"bitwise_equal": equal,
                                  "losses": runs[0][1]}
    if not equal:
        raise AssertionError(f"composed step on ('data', 'model') (1, 1) "
                             f"against ('data',): losses {runs[0][1]} vs "
                             f"{runs[1][1]}")
    log(f"[tp] one-rank NCCL mesh {json.dumps(out)}")
    return out


def ckpt_card(mesh, work) -> dict:
    """(c) The flagship's params and Adam moments after CKPT_TRAIN_STEPS
    f32 steps at B=4, T=2048: ``save_process_shards`` +
    ``merge_process_manifests`` at world size 1 on a ("data", "expert")
    mesh, then ``restore_sharded(shardings=)`` onto the card, bit-exact;
    a synchronous save's ms against an ``AsyncCheckpointer`` save whose
    writer overlaps ASYNC_OVERLAP_STEPS training steps (step ms with and
    without the pending save)."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves
    from deeplearning4j_tpu_torch.models import transformer_lm as T
    from deeplearning4j_tpu_torch.optimize.updaters import OptimizerConfig
    from deeplearning4j_tpu_torch.scaleout.ckpt import (
        AsyncCheckpointer,
        Checkpointer,
        merge_process_manifests,
        restore_sharded,
        save_process_shards,
    )
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    params, tokens, targets = _train_setup()
    opt = OptimizerConfig(name="adam", lr=ADAM_LR)
    step = T.make_single_device_train_step(N_HEADS, optimizer=opt,
                                           device=DEVICE)
    st = T.init_lm_opt_state(opt, params, device=DEVICE)
    for _ in range(CKPT_TRAIN_STEPS):
        params, st, _loss = step(params, st, tokens, targets)
    sync()
    state = {"params": params, "opt": {"m": st["m"], "v": st["v"]}}
    pspecs = T.lm_param_shardings(params, mesh)
    specs = {"params": pspecs, "opt": {"m": pspecs, "v": pspecs}}
    root = os.path.join(work, "ckpt15")
    t0 = time.perf_counter()
    save_process_shards(root, 1, state, mesh=mesh, specs=specs)
    step_dir = merge_process_manifests(root, 1, 1, mesh=mesh)
    multi_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    got, _ = restore_sharded(step_dir, state, shardings=specs,
                             device=DEVICE, mesh=mesh)
    sync()
    restore_ms = (time.perf_counter() - t0) * 1e3
    exact = all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                  tree_leaves(state)))
    nbytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
    if not exact or not all(x.is_cuda == (DEVICE == "cuda")
                            for x in tree_leaves(got)):
        raise AssertionError("multi-process save restored onto the card: "
                             "not bit-exact")
    ck = Checkpointer(os.path.join(work, "ckpt15s"),
                      registry=MetricsRegistry())
    t0 = time.perf_counter()
    ck.save(1, state)
    sync_ms = (time.perf_counter() - t0) * 1e3

    def steps(carry, n):
        p, s = carry
        sync()
        t0 = time.perf_counter()
        for _ in range(n):
            p, s, _loss = step(p, s, tokens, targets)
        sync()
        return (p, s), (time.perf_counter() - t0) * 1e3 / n

    carry, plain_ms = steps((params, st), ASYNC_OVERLAP_STEPS)
    actx = AsyncCheckpointer(Checkpointer(os.path.join(work, "ckpt15a"),
                                          registry=MetricsRegistry()))
    t0 = time.perf_counter()
    actx.save(2, {"params": carry[0], "opt": {"m": carry[1]["m"],
                                              "v": carry[1]["v"]}})
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    carry, pending_ms = steps(carry, ASYNC_OVERLAP_STEPS)
    t1 = time.perf_counter()
    actx.flush()
    flush_wait_ms = (time.perf_counter() - t1) * 1e3
    total_ms = (time.perf_counter() - t0) * 1e3
    actx.close()
    out = {"state_mib": nbytes / 2**20, "restore_bit_exact": exact,
           "multi_process_save_ms": multi_ms, "restore_ms": restore_ms,
           "sync_save_ms": sync_ms, "async_enqueue_ms": enqueue_ms,
           "step_ms": plain_ms, "step_ms_with_async_save_pending":
           pending_ms, "async_flush_wait_ms": flush_wait_ms,
           "async_save_and_steps_ms": total_ms}
    log(f"[ckpt card] {json.dumps(out)}")
    return out


def guard_card(mesh, work, attn_x, attn_y) -> dict:
    """(d) The attention char-LM's guarded sync step (``make_sync_train_
    step(guard=True)`` on the one-rank NCCL mesh; the kernels at T=2048):
    GUARD_STEPS healthy steps saved and tagged last_good, then a batch
    with a NaN: the step is skipped with params and updater state bitwise
    unchanged; after the watchdog's burst it declares divergence;
    ``rollback()`` restores the last good step, and two resumed steps
    equal an unpoisoned run from that step within ROLLBACK_TOL of each
    leaf's max."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves, tree_map
    from deeplearning4j_tpu_torch.nn import functional as F
    from deeplearning4j_tpu_torch.optimize.guardrails import \
        DivergenceWatchdog
    from deeplearning4j_tpu_torch.parallel.trainer import \
        make_sync_train_step
    from deeplearning4j_tpu_torch.scaleout.ckpt import Checkpointer
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    conf = _attn_conf()
    reg = MetricsRegistry()
    ck = Checkpointer(os.path.join(work, "guard15"), registry=reg)
    wd = DivergenceWatchdog(checkpointer=ck, registry=reg,
                            max_consecutive_skips=2,
                            replay_dir=os.path.join(work, "replay15"))
    guarded = make_sync_train_step(conf, mesh, guard=True)
    plain = make_sync_train_step(conf, mesh)
    w = np.ones((attn_x.shape[0],), np.float32)
    params = F.init_params(conf, 9, device=DEVICE)
    states = F.init_train_state(conf, params)
    it = 0
    for it in range(1, GUARD_STEPS + 1):
        params, states, score, gm = guarded(params, states, it, attn_x,
                                            attn_y, w, it)
        if wd.observe(it, score, gm) != "ok":
            raise AssertionError(f"guard: healthy step {it} not ok")
        ck.save(it, {"params": params, "states": states})
        wd.note_checkpoint(it)
    saved = tree_map(lambda _, a: a.clone(), (params, states))
    bad = attn_x.copy()
    bad[0, 0, 0] = np.nan
    verdicts, unchanged = [], True
    for it in range(GUARD_STEPS + 1, GUARD_STEPS + 4):
        before = tree_map(lambda _, a: a.clone(), (params, states))
        params, states, score, gm = guarded(params, states, it, bad, attn_y,
                                            w, it)
        unchanged = unchanged and all(torch.equal(a, b) for a, b in zip(
            tree_leaves((params, states)), tree_leaves(before)))
        verdicts.append(wd.observe(it, score, gm, batch={"x": bad}))
        if verdicts[-1] == "diverged":
            break
    if not unchanged or verdicts[-1] != "diverged" or \
            verdicts[0] != "skipped":
        raise AssertionError(f"guard: verdicts {verdicts}, params "
                             f"unchanged {unchanged}")
    template = {"params": params, "states": states}
    restored, got_step, _ = wd.rollback(template, device=DEVICE)
    exact = all(torch.equal(a, b) for a, b in zip(
        tree_leaves((restored["params"], restored["states"])),
        tree_leaves(saved)))
    a = (restored["params"], restored["states"])
    b = saved
    for i in range(2):
        a = guarded(*a, GUARD_STEPS + 1 + i, attn_x, attn_y, w, 50 + i)[:2]
        b = plain(*b, GUARD_STEPS + 1 + i, attn_x, attn_y, w, 50 + i)[:2]
    err = _max_leaf_rel(a, b)
    out = {"verdicts": verdicts, "params_unchanged_on_skip": unchanged,
           "rolled_back_to": got_step, "restore_bit_exact": exact,
           "resume_max_leaf_rel_err": err, "bundles": len(wd.bundles),
           "skipped": wd.skipped_steps}
    finite = all(bool(torch.isfinite(t).all())
                 for t in tree_leaves((a, b)))
    out["resumed_finite"] = finite
    if (got_step != GUARD_STEPS or not exact or not finite
            or not err <= ROLLBACK_TOL):
        raise AssertionError(f"guard rollback: {out}")
    log(f"[guard card] {json.dumps(out)}")
    return out


def slice20bc(smi: str) -> dict:
    """Phase 15: items 20b and 20c. (a) tensor parallelism at full width,
    every coordinate's kernel work on the card: the MNIST MLP (batch
    MLP_BATCH) at tp TP_MLP_DEGREE (K1 twice a step a coordinate) and
    the attention char-LM at ATTN_* at tp 2 and 4 (K3f, K3k and K3q once
    a step a coordinate, no K1); then, in a one-rank NCCL group, (b) the
    TP and composed steps on ("data", "model") (1, 1) bit for bit against
    their one-device twins, (c) checkpoints of the flagship's trained
    state, (d) the guard."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.models.zoo import mnist_mlp
    from deeplearning4j_tpu_torch.parallel import mesh as pmesh
    from deeplearning4j_tpu_torch.parallel import multihost

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dl4j_torch_slice20bc_")
    mx, my = (torch.from_numpy(a).to(DEVICE) for a in _mnist(MLP_BATCH, 15))
    ax_np, ay_np = _one_hot_tokens((ATTN_B, ATTN_T + 1), ATTN_VOCAB, seed=15)
    ax, ay = torch.from_numpy(ax_np).to(DEVICE), \
        torch.from_numpy(ay_np).to(DEVICE)
    out = {"mlp": tp_coordinates(
        "mnist_mlp", mnist_mlp(MLP_H1, MLP_H2), mx, my, TP_MLP_DEGREE,
        MLP_LOSS_TOL, MLP_GRAD_TOL, {"fused_dense": 2 * TP_MLP_DEGREE})}
    for tp in TP_ATTN_DEGREES:
        want = {k: tp for k in TRAIN_KERNELS}
        want["fused_dense"] = 0
        out[f"attn_tp{tp}"] = tp_coordinates(
            "attention char-LM", _attn_conf(), ax, ay, tp, ATTN_LOSS_TOL,
            ATTN_GRAD_TOL, want)
    multihost.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=DEVICE)
    try:
        backend = dist.get_backend()
        if backend != ("nccl" if DEVICE == "cuda" else "gloo"):
            raise AssertionError(f"process group backend {backend}")
        out["one_rank"] = tp_one_rank(
            pmesh.Mesh(("data", "model"), (1, 1)), mx, my, ax, ay)
        out["ckpt"] = ckpt_card(pmesh.Mesh(("data", "expert"), (1, 1)),
                                work)
        out["guard"] = guard_card(pmesh.Mesh(("data",), (1,)), work, ax_np,
                                  ay_np)
    finally:
        multihost.shutdown()
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    summary = {
        "tp_ms_per_step": {k: out[k].get("ms_per_step") for k in
                           ("mlp", "attn_tp2", "attn_tp4")},
        "coordinate_ms_per_step": {
            k: out[k].get("coordinate_ms_per_step") for k in
            ("mlp", "attn_tp2", "attn_tp4")},
        "single_device_ms_per_step": {
            k: out[k].get("single_device_ms_per_step") for k in
            ("mlp", "attn_tp2", "attn_tp4")},
        "sync_save_ms": out["ckpt"]["sync_save_ms"],
        "step_ms": out["ckpt"]["step_ms"],
        "step_ms_with_async_save_pending":
            out["ckpt"]["step_ms_with_async_save_pending"],
        "wall_s": out["wall_s"]}
    log(f"[slice20bc] {json.dumps(summary)} on {smi}")
    return out


# ------------------------------------------------- phase 16: item 20d ----

# JAX's largest elastic stage (bench.py's elastic trace A/B)
ELASTIC_WIDTH = dict(d_in=64, d_hidden=256, batch=512, lr=0.05)
ELASTIC_SYNC = 48
ELASTIC_ROUNDS = 3
ELASTIC_TOL = 1e-5       # card against CPU: of each leaf's max; loss rel.
ELASTIC_SIM_TOL = 1e-6   # a cluster's params against simulate_elastic
ELASTIC_DEAD_S = 2.0     # heartbeat staleness that buries a worker
ELASTIC_WAIT_S = 180.0   # the longest wait on a worker process
ELASTIC_NAN_STEP = ELASTIC_SYNC + 5   # (c)'s poisoned batch, in round 1
ELASTIC_MODEL = "deeplearning4j_tpu_torch.scaleout.elastic:" \
    "synthetic_regression_model"


def _elastic_model(device, **kw):
    from deeplearning4j_tpu_torch.scaleout.elastic import (
        SyntheticRegressionModel,
    )

    return SyntheticRegressionModel(**{**ELASTIC_WIDTH, **kw}, device=device)


def _host_abs(got: dict, want: dict) -> float:
    """max over leaves of max |got - want| on host arrays; inf where a
    leaf is not finite."""
    errs = [float(np.max(np.abs(np.asarray(got[k]) - np.asarray(want[k]))))
            for k in sorted(want)]
    return max(errs) if all(math.isfinite(e) for e in errs) else math.inf


def elastic_card_parity() -> dict:
    """(a) run_steps on the card against the CPU from one init and one
    batch stream (the draws are CPU generators, so both models draw the
    same), 48 steps in each variant; then the guarded skip on the card;
    then local steps/s."""
    import torch

    from deeplearning4j_tpu_torch._device import tree_leaves

    init = {k: v.cpu() for k, v in _elastic_model("cpu").init_params()
            .items()}
    out = {}
    for name, kw in (("sgd", {}), ("guard", {"guard": True}),
                     ("adam", {"optimizer": "adam"})):
        card, cpu = _elastic_model(DEVICE, **kw), _elastic_model("cpu", **kw)
        pc, lc = card.run_steps({k: v.to(DEVICE) for k, v in init.items()},
                                0, ELASTIC_SYNC, worker_seed=1)
        ph, lh = cpu.run_steps(init, 0, ELASTIC_SYNC, worker_seed=1)
        rel, lrel = _max_leaf_rel(pc, ph), abs(lc - lh) / abs(lh)
        if not (rel <= ELASTIC_TOL and lrel <= ELASTIC_TOL):
            raise AssertionError(f"elastic {name}: card against CPU params "
                                 f"{rel:.3g}, loss {lrel:.3g}")
        out[name] = {"params_rel": rel, "loss_rel": lrel, "loss": lc}
    for name, kw in (("guard", {"guard": True}),
                     ("adam_guard", {"guard": True, "optimizer": "adam"})):
        m = _elastic_model(DEVICE, nan_at_step=2, **kw)
        p0, _ = m.run_steps(init, 0, 2, worker_seed=1)
        state = [x.clone() for x in tree_leaves(m._opt_state or {})]
        p1, _ = m.run_steps(p0, 2, 1, worker_seed=1)   # the NaN batch
        # params, both moments and the step count, bitwise
        same = all(np.array_equal(p0[k], p1[k]) for k in p0) and all(
            torch.equal(a, b) for a, b in
            zip(state, tree_leaves(m._opt_state or {}), strict=True))
        if m.skipped_steps != 1 or not same:
            raise AssertionError(f"elastic {name}: NaN batch not skipped "
                                 f"bitwise ({m.skipped_steps} skips)")
    m = _elastic_model(DEVICE)
    p, _ = m.run_steps(init, 0, ELASTIC_SYNC, worker_seed=1)   # warm-up
    walls = []
    for r in range(3):
        sync()
        t0 = time.perf_counter()
        p, _ = m.run_steps(p, (r + 1) * ELASTIC_SYNC, ELASTIC_SYNC,
                           worker_seed=1)
        walls.append(time.perf_counter() - t0)
    out["steps_per_s"] = ELASTIC_SYNC / statistics.median(walls)
    log(f"[elastic] card against CPU: {json.dumps(out)}")
    return out


def _spawn_elastic(address, blob, wid, seed, extra=(), kwargs=None,
                   entry=("-m", "deeplearning4j_tpu_torch.scaleout.elastic")):
    proc = subprocess.Popen(
        [sys.executable, *entry, "--connect", address, "--blob", blob, "--model", ELASTIC_MODEL,
         "--kwargs-json", json.dumps({**ELASTIC_WIDTH, **(kwargs or {})}),
         "--device", DEVICE, "--worker-id", wid, "--worker-seed", str(seed),
         "--sync-every", str(ELASTIC_SYNC), "--round-timeout-s",
         str(ELASTIC_WAIT_S), *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO)
    proc.lines = []
    proc.drain = threading.Thread(target=_drain, daemon=True,
                                  args=(proc, proc.lines))
    proc.drain.start()
    return proc


def _reap(procs: dict) -> dict:
    """Every worker's exit code, waiting at most ELASTIC_WAIT_S; a worker
    still running is killed and fails the phase."""
    codes, hung = {}, []
    deadline = time.monotonic() + ELASTIC_WAIT_S
    for wid, proc in procs.items():
        try:
            codes[wid] = proc.wait(timeout=max(1.0, deadline
                                               - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            codes[wid] = proc.wait(timeout=30)
            hung.append(wid)
    if hung:
        raise AssertionError(f"elastic workers {hung} did not exit")
    return codes


def _worker_steps_per_s(trace_dir: str, process: str) -> float:
    """Local steps/s inside a worker's ``worker.steps`` spans after its
    first round (the protocol's waits and the process's warm-up
    excluded), from its span file."""
    n = ms = 0.0
    with open(os.path.join(trace_dir, f"spans_{process}.jsonl")) as fh:
        for line in fh:
            rec = json.loads(line)
            if (rec.get("ev") == "E" and rec["name"] == "worker.steps"
                    and rec["attrs"]["round"] >= 1):
                n += rec["attrs"]["n_steps"]
                ms += rec["dur_ms"]
    return n / (ms / 1000.0)


def _baseline_steps_per_s(device: str) -> float:
    """The survivor's local steps with no protocol around them: round 0's
    window (warm-up), then the windows of rounds 1.. of worker seed 1,
    each from host params as a worker adopts them, timed as its
    ``worker.steps`` spans are."""
    m = _elastic_model(device)
    p, _ = m.run_steps(m.init_params(), 0, ELASTIC_SYNC, worker_seed=1)
    wall = 0.0
    for r in range(1, ELASTIC_ROUNDS):
        t0 = time.perf_counter()
        p, _ = m.run_steps(p, r * ELASTIC_SYNC, ELASTIC_SYNC, worker_seed=1)
        wall += time.perf_counter() - t0
    return (ELASTIC_ROUNDS - 1) * ELASTIC_SYNC / wall


def elastic_survivor(argv: list) -> None:
    """The survivor's process: the worker CLI on ``argv``, then, alone on
    the card once the cluster has finished, ``_baseline_steps_per_s`` in
    the same process, so the two rates differ by the protocol and not by
    the process that ran them. Prints ``ELASTIC_BASELINE {json}``."""
    from deeplearning4j_tpu_torch.scaleout.elastic import worker_main

    worker_main(argv)
    device = argv[argv.index("--device") + 1]
    print("ELASTIC_BASELINE " + json.dumps(
        {"steps_per_s": _baseline_steps_per_s(device)}), flush=True)


def elastic_cluster(work: str) -> dict:
    """(b) a master in this process, a survivor and a victim process on
    the card; the victim crashes after one step of round 0. The
    survivor's local steps/s and the cluster's are set against the
    baseline that ``elastic_survivor`` times in the survivor's own
    process after the cluster."""
    from deeplearning4j_tpu_torch.scaleout.elastic import (
        ElasticMaster,
        simulate_elastic,
    )
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    blob = "file://" + os.path.join(work, "blob_b")
    trace_dir = os.path.join(work, "trace_b")
    master = ElasticMaster(_elastic_model(DEVICE), blob,
                           sync_every=ELASTIC_SYNC, min_workers=1,
                           worker_timeout_s=ELASTIC_DEAD_S,
                           register_timeout_s=ELASTIC_WAIT_S,
                           round_timeout_s=ELASTIC_WAIT_S,
                           registry=MetricsRegistry())
    procs = {}
    times = {}
    stop = threading.Event()

    def watch():
        beats = None
        while not stop.is_set():
            count = master.tracker.count("hb.victim")
            if count != beats:
                beats, times["last_beat"] = count, time.monotonic()
            if "exit" not in times and procs["victim"].poll() is not None:
                times["exit"] = time.monotonic()
            if "burial" not in times and \
                    master.tracker.count("workers_failed") >= 1:
                times["burial"] = time.monotonic()
            stop.wait(0.005)

    try:
        t0 = time.perf_counter()
        procs["survivor"] = _spawn_elastic(
            master.address, blob, "survivor", 1,
            extra=["--trace-dir", trace_dir],
            entry=("-c", "import sys, chip_smoke as cs; "
                   "cs.elastic_survivor(sys.argv[1:])"))
        procs["victim"] = _spawn_elastic(
            master.address, blob, "victim", 2,
            extra=["--crash-at-round", "0", "--crash-after-steps", "1"])
        threading.Thread(target=watch, daemon=True).start()
        master.wait_for_workers(2)
        start_s = time.perf_counter() - t0
        round_s = []
        for r in range(ELASTIC_ROUNDS):
            t1 = time.perf_counter()
            final = master.train(rounds=1, finish=r == ELASTIC_ROUNDS - 1)
            round_s.append(time.perf_counter() - t1)
        codes = _reap(procs)
    finally:
        stop.set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        master.shutdown()
    failed = master.tracker.count("workers_failed")
    if codes != {"survivor": 0, "victim": 23} or failed != 1:
        raise AssertionError(
            f"elastic cluster: exits {codes}, workers_failed {failed}:\n"
            + "".join(procs["survivor"].lines[-20:]
                      + procs["victim"].lines[-20:]))
    ref, _ = simulate_elastic(_elastic_model(DEVICE), [1],
                              sync_every=ELASTIC_SYNC, rounds=ELASTIC_ROUNDS)
    err = _host_abs(final, ref)
    if not err <= ELASTIC_SIM_TOL:
        raise AssertionError(f"elastic cluster: survivor params {err:.3g} "
                             "from simulate_elastic")
    procs["survivor"].drain.join(timeout=30)
    line = [x for x in procs["survivor"].lines
            if x.startswith("ELASTIC_BASELINE ")]
    if not line:
        raise AssertionError("elastic cluster: the survivor printed no "
                             "baseline:\n"
                             + "".join(procs["survivor"].lines[-20:]))
    baseline = json.loads(line[0].split(" ", 1)[1])["steps_per_s"]
    survivor = _worker_steps_per_s(trace_dir, "survivor")
    cluster = ELASTIC_SYNC / statistics.mean(round_s[1:])
    out = {"start_s": start_s, "round_s": round_s,
           "s_a_round": statistics.mean(round_s[1:]),
           "exit_seen_to_burial_s": times["burial"] - times["exit"],
           "last_beat_to_burial_s": times["burial"] - times["last_beat"],
           "baseline_steps_per_s": baseline,
           "survivor_steps_per_s": survivor,
           "cluster_steps_per_s": cluster,
           "survivor_over_baseline": survivor / baseline,
           "cluster_over_baseline": cluster / baseline,
           "params_abs_err": err, "exits": codes}
    log(f"[elastic] cluster: {json.dumps(out)}")
    return out


def elastic_watch_ckpt(work: str) -> dict:
    """(c) three workers, the third poisoned by nan_at_step in round 1;
    the master watches and checkpoints every version; then a fresh
    master resumes."""
    from deeplearning4j_tpu_torch.scaleout.ckpt import (
        AsyncCheckpointer,
        Checkpointer,
    )
    from deeplearning4j_tpu_torch.scaleout.elastic import (
        ElasticMaster,
        simulate_elastic,
    )
    from deeplearning4j_tpu_torch.scaleout.remote_tracker import (
        StateTrackerClient,
    )
    from deeplearning4j_tpu_torch.telemetry.federation import (
        ClusterAggregator,
    )
    from deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

    poison = {"nan_at_step": ELASTIC_NAN_STEP, "nan_worker_seed": 3}
    blob = "file://" + os.path.join(work, "blob_c")
    root = os.path.join(work, "ckpt_c")
    reg = MetricsRegistry()
    ck = AsyncCheckpointer(Checkpointer(root, keep_last=ELASTIC_ROUNDS,
                                        registry=reg))
    master = ElasticMaster(_elastic_model(DEVICE), blob,
                           sync_every=ELASTIC_SYNC, min_workers=1,
                           worker_timeout_s=30.0,
                           register_timeout_s=ELASTIC_WAIT_S,
                           round_timeout_s=ELASTIC_WAIT_S, registry=reg,
                           checkpointer=ck, checkpoint_every=1, watch=True,
                           watch_dir=os.path.join(work, "watch_c"))
    procs = {}
    times = {}
    stop = threading.Event()
    engine = master.watchtower.engine

    def watch():
        while not stop.is_set():
            if "quarantine" not in times and reg.counter(
                    "elastic_workers_quarantined_total").value >= 1:
                times["quarantine"] = time.monotonic()
            if "quarantine" in times and any(
                    s["rule"] == "worker_divergence"
                    and s["state"] == "firing" for s in engine.states()):
                times["firing"] = time.monotonic()
                return
            stop.wait(0.005)

    view = None
    try:
        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        for wid, seed in (("w1", 1), ("w2", 2), ("poisoned", 3)):
            procs[wid] = _spawn_elastic(master.address, blob, wid, seed,
                                        kwargs=poison)
        master.wait_for_workers(3)
        final = master.train(rounds=ELASTIC_ROUNDS, finish=False)
        watcher.join(timeout=30)
        client = StateTrackerClient(master.address)
        try:
            view = ClusterAggregator(client, stale_after_s=3600.0,
                                     registry=MetricsRegistry()
                                     ).collect_alerts()
        finally:
            client.close()
        master.tracker.finish()
        codes = _reap(procs)
    finally:
        stop.set()
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
        master.shutdown()   # ticks the watchtower, flushes the saves
    quarantined = master.tracker.count("workers_quarantined")
    by = {(a["process"], a["rule"]): a["state"] for a in view["alerts"]}
    if (quarantined != 1 or "firing" not in times
            or by.get(("master", "worker_divergence")) != "firing"
            or codes != {"w1": 0, "w2": 0, "poisoned": 0}):
        raise AssertionError(
            f"elastic watch: quarantined {quarantined}, times {times}, "
            f"alerts {by}, exits {codes}:\n"
            + "".join(procs["poisoned"].lines[-20:]))
    ref, _ = simulate_elastic(_elastic_model(DEVICE, **poison), [1, 2, 3],
                              sync_every=ELASTIC_SYNC, rounds=ELASTIC_ROUNDS,
                              schedule={0: [0, 1, 2], 1: [0, 1], 2: [0, 1]})
    err = _host_abs(final, ref)
    saves = reg.counter("ckpt_async_saves_total").value
    if not (err <= ELASTIC_SIM_TOL and saves == ELASTIC_ROUNDS
            and reg.counter("ckpt_async_failures_total").value == 0):
        raise AssertionError(f"elastic watch: params {err:.3g} from "
                             f"simulate_elastic, {saves} async saves")
    fresh = ElasticMaster(_elastic_model(DEVICE),
                          "file://" + os.path.join(work, "blob_c2"),
                          sync_every=ELASTIC_SYNC,
                          checkpointer=Checkpointer(root),
                          registry=MetricsRegistry())
    try:
        t0 = time.perf_counter()
        resumed = fresh.resume()
        resume_ms = (time.perf_counter() - t0) * 1000.0
        exact = all(np.array_equal(fresh.params()[k], final[k])
                    for k in final)
    finally:
        fresh.shutdown()
    if resumed != ELASTIC_ROUNDS or not exact:
        raise AssertionError(f"elastic resume: version {resumed}, "
                             f"bit-exact {exact}")
    out = {"quarantine_to_firing_s": times["firing"] - times["quarantine"],
           "params_abs_err": err, "async_saves": saves,
           "resume_ms": resume_ms, "exits": codes,
           "cluster_firing": view["firing"]}
    log(f"[elastic] watch and checkpoint: {json.dumps(out)}")
    return out


def slice20d(smi: str) -> dict:
    """Phase 16: item 20d, elastic parameter averaging on the card."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    work = tempfile.mkdtemp(prefix="dl4j_torch_slice20d_")
    try:
        out = {"parity": elastic_card_parity()}
        out["cluster"] = elastic_cluster(work)
        out["watch"] = elastic_watch_ckpt(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t0
    summary = {
        "in_process_steps_per_s": out["parity"]["steps_per_s"],
        **{k: out["cluster"][k] for k in (
            "baseline_steps_per_s", "survivor_steps_per_s",
            "cluster_steps_per_s", "survivor_over_baseline",
            "cluster_over_baseline")},
        "s_a_round": out["cluster"]["s_a_round"],
        "exit_seen_to_burial_s": out["cluster"]["exit_seen_to_burial_s"],
        "last_beat_to_burial_s": out["cluster"]["last_beat_to_burial_s"],
        "quarantine_to_firing_s": out["watch"]["quarantine_to_firing_s"],
        "wall_s": out["wall_s"]}
    log(f"[slice20d] {json.dumps(summary)} on {smi}")
    return out


# ---------------------------------------------------------------- main ----

def main() -> int:
    import torch

    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on a GPU",
              file=sys.stderr)
        return 2
    from deeplearning4j_tpu_torch.models.transformer_lm import init_lm_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}; nvidia-smi: {smi}")

    build_kernels()
    flash_parity()
    bwd_parity()
    serve_entry = flash_measure()
    train_entries = train_shape_measure()

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = init_lm_params(gen, VOCAB, D_MODEL, N_HEADS, N_EXPERTS, D_FF,
                            n_layers=N_LAYERS, device=DEVICE)
    main_run = serve(params, None, PROMPT_LENS, seed=1)
    serve_entry["launches"] = main_run["kernel_launches"]
    serve(params, "flash", FLASH_PROMPT_LENS, seed=2)
    serve(params, None, PROMPT_LENS, seed=3, profiled=True)
    prefill_parity(params)
    fast = fastpath(params)
    serve_entry["fastpath_launches"] = {
        name: run["k3f_launches"] for name, run in fast["bf16"].items()}
    del params

    train_main = train()
    trained = train_main.pop("params")
    for entry in train_entries:
        entry["launches"] = train_main["launches"][entry["name"]]
        entry["launches_cover"] = ("the timed f32 training run (the "
                                   "training path's type)")
    grad_parity()
    optimizer_path()
    train(profiled=True)
    wide_head_step()

    mlp_entries, mlp_main = mlp()
    lstm_entries = lstm()
    attn_lm()

    cli_run = cli(trained, main_run["tokens_per_s"],
                  mlp_main["ms_per_step"])
    serve_entry["cli_launches"] = {"predict": cli_run["lm"]["flash_launches"]}
    for entry in mlp_entries:
        entry["cli_launches"] = cli_run["mlp"]["launches"]
    conv_entries = slice5()
    nlp = slice6(smi)
    trainer = slice7(smi)["trainer"]
    s8 = slice8(smi, nlp["large"]["words_per_s"])
    for entry in train_entries:
        # the data-parallel step's f32 runs (phase 12)
        entry["dp_launches"] = {
            mode: s8["lm_dp"][mode]["launches"][entry["name"]]
            for mode in ("sgd", "adam_replicated", "adam_sharded")}
    for entry in mlp_entries:
        entry["trainer_launches"] = {
            run: trainer[run]["launches"] for run in ("sync", "local")}
        entry["trainer_launches"].update({
            f"adam_{mode}": trainer["adam"][mode]["launches"]
            for mode in ("replicated", "sharded")})
        entry["runner_launches"] = s8["runner"]["sync"]["launches"]
    s4c = slice4c(smi, s8["runner"]["sync"]["samples_per_s"])
    # K3f over the fleet's counted runs (f32 and the timed bf16 run), K1
    # over the DistributedMaster's in-process workers
    serve_entry["fleet_launches"] = {
        "f32": s4c["fleet"]["f32"]["k3f_launches"],
        "bf16": s4c["fleet"]["bf16"]["fleet"]["k3f_launches"]}
    for entry in mlp_entries:
        entry["distributed_launches"] = s4c["distributed"]["launches"]
    s20 = slice20a(smi, train_main["ms_per_step"],
                   s8["lm_dp"]["sgd"]["ms_per_step"])
    for entry in train_entries:
        # item 20a's runs (phase 14): the ring's call over RING_SHARDS
        # shards at the entry's type, the composed steps, the staged steps
        name = entry["name"]
        ring_type = "bfloat16" if "bfloat16" in entry["shape"] else "float32"
        entry["ring_launches"] = s20["ring"][ring_type]["launches"][name]
        entry["composed_launches"] = {
            run: s20["composed"][run]["launches"][name]
            for run in ("sgd", "adam", "drops")}
        entry["pp_launches"] = {
            run: s20["pp"][run]["launches"][name]
            for run in ("strict", "overlap")}
    for entry in mlp_entries + [e for e in conv_entries
                                if e["name"] == "fused_dense"]:
        entry["pp_launches"] = s20["pp"]["dense"]["k1_launches"]
    s20bc = slice20bc(smi)
    for entry in train_entries:
        # items 20b and 20c's runs (phase 15): one in-process step of
        # every coordinate of the attention char-LM at tp 2 and 4
        entry["tp_launches"] = {
            f"tp{tp}": s20bc[f"attn_tp{tp}"]["launches"][entry["name"]]
            for tp in TP_ATTN_DEGREES}
    for entry in mlp_entries + [e for e in conv_entries
                                if e["name"] == "fused_dense"]:
        # the MNIST MLP's in-process step over its tp coordinates
        entry["tp_launches"] = {
            f"tp{TP_MLP_DEGREE}": s20bc["mlp"]["launches"]["fused_dense"]}
    slice20d(smi)   # no kernel on its path: the JAX model is plain jnp
    log(f"[time] chip_smoke ran {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [serve_entry, *train_entries,
                                  *mlp_entries, *lstm_entries,
                                  *conv_entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
