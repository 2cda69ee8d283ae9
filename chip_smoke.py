#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mxnet_tpu_torch) on one NVIDIA H100.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card. It

1. builds the port's CUDA kernels from ``mxnet_tpu_torch/csrc`` (into
   ``mxnet_tpu_torch/_build/``) and prints the build time;
2. holds the LayerNorm forward kernel against its plain PyTorch version
   (the bert512 step's (8192, 768) and (1280, 768) bf16 first; a decode
   step's (8, 768) at eps 1e-5, a C that is not a multiple of 8, rows above
   the in-register forms, an x off 16-byte alignment; a row's output at 8
   rows equal to the same row's at 4096; the fp32 rows of the int8 paths:
   (4096, 768) and (256-1024, 768)), and the LayerNorm backward kernel
   (dx, dgamma, dbeta) against its plain version at the step's two shapes,
   (8, 768), fp32 and the loop form's rows, each run twice: dgamma and
   dbeta must be bit-equal;
3. holds the flash-attention forward kernel against its plain version
   (the bert512 step's (16, 12, 512, 64) with the logsumexp first, run
   twice: the two outputs must be identical; valid lengths with 0, causal,
   ragged T = 200, head dim 128, T = 2048 with vl 1900, causal T = 192
   with valid lengths, T = 1, head dim 128 causal, a negative scale), and
   its fp32 form (the quantized paths' attention, 3xTF32 on the tensor
   cores) at the int8 BERT forward's (8, 12, 512, 64) with valid lengths
   (twice, identical), the int8 GPT prefills' causal (1, 12, 256-1024, 64),
   the int8 BERT forwards at buckets 1 (split; each served valid length,
   the one over 256 keys twice, identical) and 4 with the served valid
   lengths, the tile edges and the split key range (batch-1 causal at T = 640, 700,
   2000 and 2048, head dim 128, valid lengths 1 and 0 in a split batch;
   the causal 512 twice, identical), and a planted reading: the plain
   version on TF32-rounded operands must read above the limit;
4. holds the softmax cross-entropy forward and backward kernels against
   their plain versions ((1280, 30522) bf16, (16, 2), (37, 1000) fp32, and
   a padded vocabulary sliced to V: (64, 50257) bf16 rows 50264 apart,
   (37, 1000) fp32 rows 1003 apart; a label in the last column);
5. holds the flash-attention backward kernel (dq, dk and dv from one
   kernel and its dq pass) against its plain version (every key valid at
   (16, 12, 512, 64), valid lengths with 0, causal, ragged T = 200, head
   dim 128, 30 key tiles adding into each dq row at T = 2048), checks that
   dk and dv rows past the valid length are exactly zero, and runs the
   bert512 case twice to read how far dq moves between runs (its partial
   sums land in no fixed order);
6. serves BERT-base (full width, bf16, random weights from a seed) through
   ``ModelServer(buckets=(1, 4, 8))`` at seq 512: 16 requests with valid
   lengths spread over 1..512; every served row must match a direct forward
   of the same model on the card, which must match the same forward with
   the plain versions in place of the kernels (a forward in which no
   kernel may launch); the LayerNorm and flash
   counters must rise by 25 and 12 per forward, and no training kernel may
   launch; it serves two bursts and prints each one's p50/p99 latency and
   req/s; every bucket is one CUDA graph, captured at warmup (three
   captures, none in traffic);
6a. holds the served BERT buckets' graphs (``phase_serve_graph``, bf16
   here and int8 after step 12): each bucket's replay bitwise equal to an
   eager forward of the same padded batch (a replay on stale input buffers,
   planted, must differ), 25 LayerNorm and 12 flash launches a replay, the
   host wall of a bucket-8 dispatch through its graph and eagerly and the
   graph's device time; a ``swap_parameters`` in the middle of a burst
   (no failed request, no capture, each batch bitwise the old or the new
   weights' eager forward, every request after the swap returned on the
   new weights; a swap that rebinds the parameters, planted, must show),
   a refused file that keeps the old weights, and ``retune_buckets`` on
   the measured request sizes capturing exactly the new set;
7. trains BERT-base at the ``bert512`` recipe of ``bench.py`` (batch 16,
   seq 512, 80 masked positions, bf16 with fp32 masters, Adam lr 1e-4 wd
   0.01, dropout 0.1, MLM + NSP loss) through ``autograd.record``,
   ``autograd.backward`` and ``gluon.Trainer.step``: the loss stays finite
   and the weights move; the kernel counters rise by exactly 26 LayerNorm
   forward, 26 LayerNorm backward, 12 flash forward, 12 flash backward, 2
   softmax-xent forward and 2 backward launches a step; one step's loss
   and every gradient agree with
   the same step run with the plain versions (no kernel may launch in it),
   and the same plain step with planted faults (LayerNorm gamma 1 % high,
   dk/dv missing a query tile) must fail the gradient limit; it times the
   step (samples/s);
8. times the ``bert`` headline step (batch 64, seq 128, 20 masked), whose
   attention takes the dense path and its hand-written backward;
8a. trains GPT-2 small (full width, bf16 via amp, dropout 0.1, random
   weights from a seed) as a user of the JAX package writes it
   (``phase_gpt_train``): batch 8 of 1025 random tokens, input the first
   1024 and target the last 1024, next-token ``SoftmaxCrossEntropyLoss``
   over the (8, 1024, 50257) logits, Adam lr 1e-4 wd 0.01 with fp32
   masters: finite losses, weights that move, exactly 25 LayerNorm forward
   and backward, 12 causal flash forward (with the lse) and backward and 1
   softmax-xent forward and backward launches a step; one step against the
   same step with the plain versions (loss, each gradient's and its worst
   row's relative L2), and that plain step with planted faults (the flash
   backward without its first key tile, the softmax-xent dx without each
   row's unaligned tail) above the limits and the plain step run again
   within them; the step's host wall, tokens/s and peak memory;
8c. trains the same GPT-2 small three steps in MXNet's imperative idiom
   (``phase_nd_train``: ``nd.array`` tokens, ``loss = loss_fn(net(x), y)``
   under ``autograd.record()``, ``loss.backward()``, ``trainer.step(8)``,
   ``loss.mean().asscalar()``) beside the tensor path twice from the same
   state and dropout draws: the first loss bitwise the tensor path's, each
   step equal to it bit for bit wherever the tensor path reproduces
   itself (its flash dq sums in no fixed order) and no further from it
   than its own second run elsewhere, the same kernel launches a step,
   the host wall of a step both ways; runs every ``nd`` op of
   ``tools/nd_op_cases.py`` on the card against the CPU, forward and
   gradient, and ``nd.LayerNorm``, ``nd.softmax_cross_entropy`` and a
   causal T = 1024 ``nd.scaled_dot_attention``, which must launch their
   forward and backward kernels and agree with their plain versions
   (``phase_nd_ops``); and holds a WGAN-GP critic's gradient-penalty
   gradients (``autograd.grad(create_graph=True)``, input 768, hidden
   3072) to the CPU's, checks that the same through ``nd.LayerNorm``
   raises ``SecondOrderError`` on the card, and that a planted unguarded
   LayerNorm Function's silent second order reads above the limit
   (``phase_create_graph``);
8b. takes one ``Trainer.step`` of each of the fifteen optimizers over
   GPT-2 small's parameters (bf16, fp32 masters) from the same seeded
   gradients (``phase_optimizers``), each against the same port code on
   the CPU in fp32 (``OPTIM_STEP_TOL``; SGLD with its noise as zeros, then
   its noise's moments; a LAMB reference without its trust ratio, planted,
   must read above the limit), and trains GPT-2 small three steps with
   SGD under a cosine schedule with warmup and three with LAMB
   (``phase_gpt_train_optimizers``: finite losses, weights that move, the
   scheduler's rate at each step, exact launches, the step's host wall;
   the optimizer's device time comes in step 14);
9. serves GPT-2 small (full width, bf16, random weights from a seed)
   through ``GenerativeServer(slots=8, top_k=40, prefix_cache=True)`` in
   two bursts of 12 requests (prompts of 8 to 900 tokens, at least four
   over 256 so the causal flash runs and four of 128 or fewer, repeats
   that hit the prefix cache, three sampled at temperature 0.8 with fixed
   seeds; 64 new tokens each): (a) every greedy stream equals a batch-1
   ``GPTModel.generate`` of the same model up to a step where the
   reference's logit of its token leads that of the served token by less
   than ``GREEDY_TIE_TOL``, and a stream that parts, driven again alone,
   gives logits within ``GEN_TOL`` of the reference's at every step up to
   the parting; (b) a prefix hit's stream equals its miss's; (c) a sampled
   stream is the same in both bursts, among other companions; (d) a
   prefill at buckets 256, 512 and 1024 with the kernels agrees with the
   plain versions, and the
   plain versions with a planted fault (a flash without its causal mask,
   a LayerNorm gamma 1 % high) do not; (e) the counters rise by exactly 25
   LayerNorm a prefill and a decode step and 12 flash a prefill at a
   bucket of 256 or more, none for a prefix inject, and no training
   kernel; (f) a weight swap through ``save_parameters`` makes a greedy
   stream the second model's. It prints time to first token, the decode
   step's host wall, tokens/s and peak memory; every decode step replays
   its CUDA graph (one replay a step, no capture after warmup);
9a. serves, on a fresh graphed GPT-2 server, a prompt with the id vocab +
   43 and one with -1 beside a good stream (``phase_bad_ids``): no device
   assert and no error, the good stream equal to its solo run, the first
   bad stream all token 0 and the -1 stream equal to its prompt with
   vocab - 1 in its place (``jnp.take``'s fill mode, as on the CPU);
10. holds each GPT decode step's CUDA graph against the same step run
   eagerly (``phase_graph``), bf16 and int8, greedy and sampled, after a
   capacity migration and after a weight swap, each from one saved state
   of 8 filled slots: tokens and logits bitwise equal, one replay a step
   and no capture in the steady state, 25 LayerNorm launches a step under
   replay as eagerly; prints a step's host wall each way; then the verify
   step (greedy and sampled), a 2-layer draft's round and a prefill chunk
   (greedy and sampled) each against its eager run the same way
   (``spec_programs_against_eager``: 25, 20 and 25 LayerNorm launches);
10a. serves GPT-2 small with speculative decode (``phase_speculative``,
   ``spec_k=4``): one burst of 12 requests (six repetitive prompts, a
   pattern of 16-64 tokens repeated to 200-900 tokens, and six random
   ones; greedy and sampled, 64 new tokens) through a plain server, whose
   logits are recorded, then with ``NGramDraft``, with the target as its
   own ``ModelDraft`` (greedy requests; its accept rate at least
   ``SELF_DRAFT_ACCEPT_FLOOR``) and with a 2-layer ``ModelDraft`` at the
   same widths; each stream equals the plain server's up to a step where
   the plain server's own token led by less than ``GREEDY_TIE_TOL``
   (greedy: logits; sampled: the sampler's scores at the same (seed,
   position)), a parted greedy stream driven again alone; exact launches
   (25 LayerNorm a prefill and a verify step, 12 flash a prefill at a
   bucket of 256 or more, none in a verify step; the 2-layer draft 20
   LayerNorm a round, 5 and 2 flash a fill at a bucket of 256 or more), no
   capture after warmup, one verify and one draft replay a round; then
   int8 with ``NGramDraft`` against the plain int8 server under
   ``INT8_TIE_TOL``. It prints the accept rates, the verify step's host
   wall against the plain step's and tokens/s with and without a draft;
10b. joins a 900-token prompt to four streams in flight with
   ``prefill_chunk=256`` (``phase_chunked_prefill``), tick by tick, bf16
   and int8: 4 chunks, each stream in flight gains a token on at least 3
   of the 4 chunk ticks, every stream equal to the unchunked server's
   under the same rule, exact launches; it prints the longest tick while
   the prompt joins, chunked against unchunked, and ``itl_prefill``;
11. holds ``F.quantized_fully_connected`` at the quantized models'
   shapes against an fp64 product of the same quantized operands
   (``phase_lowbit``): int8 bit for bit, e5m2 within the fp32 summation
   bound, e4m3 within ``LOWBIT_SUM_TOL``;
12. serves GPT-2 small with int8 weights and int8 KV pages through
   ``GenerativeServer(quantize="int8")`` in the same two bursts
   (``phase_generate_quant``): exact launches (25 LayerNorm a prefill and
   a step, 12 of the flash forward's fp32 form a prefill at a bucket of
   256 or more: the quantized q/k/v are fp32), the KV bytes at most 0.55x
   a bf16 cache's; the quantized step, and prefills at buckets 256, 512
   and 1024, with the kernels against the plain versions, planted faults
   above the limits; then e4m3 and e5m2 weights, one short burst each;
   serves BERT-base with int8 weights through ``ModelServer(quantize=
   "int8")`` at seq 512 (``phase_serve_quant``) in batches that fill
   their bucket: every served row equal to a direct quantized forward,
   25 LayerNorm and 12 fp32 flash launches a forward, a bucket-8 forward
   with the kernels against the plain versions, planted faults above;
12a. snapshots a warmed bf16 ``GenerativeServer`` (prefix cache,
   ``prefill_chunk=256``, ``NGramDraft``) and a warmed int8 one, and loads
   each with ``serve.load(prefix, snapshot=True, model=gpt2_small())``
   (``phase_snapshot``): load captures exactly the listed step programs
   (and runs no eager bucket), a
   request and burst 1 of ``phase_generate`` after it capture nothing, the
   parameters are bit-equal, the streams equal a plain server's under the
   tie-margin rule, an edited fingerprint warns once and still serves; it
   prints the time from ``serve.load`` to the first token beside a cold
   replica's from the same artifact and a cold server's;
12b. trains ResNet-50 v1 (``resnet50_v1(classes=1000)``, random weights
   from a seed) at ``bench.py``'s ``resnet50`` recipe
   (``phase_resnet_train``): a fixed batch of 128 fp32 images of 224x224
   cast to bf16 at entry, amp bf16, ``SoftmaxCrossEntropyLoss``, SGD lr
   0.1 momentum 0.9 wd 1e-4 with fp32 masters through ``autograd.record``,
   ``backward`` and ``gluon.Trainer``: 10 steps whose loss falls, exactly
   one softmax-xent forward and backward launch a step and no other
   kernel; one step against the same step with the plain versions (loss,
   each gradient's and its worst row's relative L2, each BatchNorm moving
   statistic), two planted faults (BatchNorm's statistics from half the
   batch; the softmax-xent dx without each row's last 8 columns) above the
   limits and the plain step again within them; the bf16 step against the
   fp32 step from the zero-init residual start; BatchNorm's moving
   variance at N*H*W = 2 (biased, where an unbiased one reads 2x); the
   step's wall by CUDA events and by the host, images/s, peak memory, and
   again with ``cudnn.benchmark`` on; serves it (``phase_resnet_serve``)
   through ``ModelServer(buckets=(1, 8, 32))`` in bf16 and int8 (naive
   calibration): one graph a bucket bitwise equal to an eager run, no
   capture in traffic, served rows against a direct forward, a bucket-32
   replay's device time, the int8 convolution at the model's 20 shapes
   equal to the exact product, the top-1 agreement of int8 with bf16;
   and runs vgg16_bn, alexnet, squeezenet1.1, mobilenet1.0,
   mobilenetv2_1.0, densenet121, inceptionv3, resnet18_v2 and
   resnet50_v1b forward and backward at batch 8 against the same weights
   on the CPU (``phase_vision_zoo``);
12c. runs the rest of BASELINE.md's configs at ``bench.py``'s recipes
   (``run_a11``): trains ``lstm_ptb`` (vocabulary 10000, tied, dropout
   0.5, bf16, SGD lr 1.0, batch 32 x bptt 35; ``phase_lstm_train``:
   finite losses, weights that move, exactly one softmax-xent launch each
   way a step and no other kernel, one step against the plain versions
   with planted faults (the LSTM's forget and input gates swapped, the
   softmax-xent dx without each row's last 8 columns), the step's wall,
   tokens/s, and the recurrence alone against cuDNN's bf16 ``nn.LSTM``);
   runs the PTB evaluation idiom in fp32 (``phase_lstm_infer``: 4 chunks
   of 35 tokens with the states carried, equal to one forward over 140
   and to the CPU); trains ``ssd_512`` (20 classes, bf16, SGD momentum,
   batch 32 at 512 x 512 with 8 boxes an image; ``phase_ssd_train``: 10
   steps on one batch whose loss falls, no kernel launches, images/s,
   peak memory; at batch 2 in fp32 one step against the CPU's) and
   detects at batch 8 (``phase_ssd_detect``: the card's ``box_nms``
   keeps the CPU's entries on the same decoded boxes; the 5456-step NMS
   loop timed); trains ``transformer_base`` (vocabulary 32000, bf16, Adam,
   batch 32 of 64 + 64 tokens; ``phase_nmt_train``: exactly 30 LayerNorm
   launches each way and one softmax-xent each way a step, no flash, one
   step against the plain versions with planted faults (LayerNorm gamma
   1 % high, the softmax-xent dx without its last 8 columns)) and
   translates (``phase_nmt_translate``: greedy at batch 8 over the fixed
   cache equal to greedy by re-forward, bf16 and fp32, 12 LayerNorm
   launches an encode and 18 a decode step, ms a token; beam 4);
12d. converts pretrained weights (``phase_convert``): a seeded
   torchvision-keyed ResNet-50 state dict (``tools/torch_resnet_ref.py``)
   saved as ``.pth`` and loaded through ``get_model("resnet50_v1b",
   pretrained=...)``, its fp32 logits at batch 8 within 1e-3 of the
   largest logit of the torch model on the card; a HuggingFace-named
   BERT-base state dict transplanted (fused qkv) and served at seq 512
   through ``ModelServer`` (25 LayerNorm and 12 flash launches a forward,
   rows within ``MODEL_TOL`` of the plain versions); a HuggingFace-named
   GPT-2 small transplanted and greedy decoded after a 300-token prompt
   (equal to the plain versions' stream under the tie rule);
12e. trains GPT-2 small at ``phase_gpt_train``'s recipe through
   ``dist.attach`` over an NCCL group of one rank, mesh ``{"dcn": 1,
   "dp": 1}`` with every collective launched (``phase_dist_train``): ZeRO
   0-3 uncompressed, two steps each (their parameters' distance from the
   plain Trainer's, beside a second plain run's, as a reading); fp16, int8
   and 2-bit compression x ZeRO 0-3, one step each, ``acc ==
   deq(payload) + residual`` exactly in every bucket; exact launches,
   bucket launches equal to the plan, no plan after the first, the first
   bucket's whole exchange done on the device before the backward's last
   gradient lands (CUDA events), the step's host enqueue, wall and device
   span; at every ZeRO stage the exchanged gradients within GPT-2's
   gradient limits of the plain step's, and a planted fault (each
   bucket's last member zeroed) above them; at every ZeRO stage the
   update from the plain step's gradients (exchange, sharded update,
   ZeRO-3 release and gather) equal to the plain Trainer's (fp32 values'
   steps within ``DIST_UPDATE_TOL`` relative L2, bf16 weights bitwise),
   and a planted fault (the first weight block's update skipped) above
   it; then
   ``ModelServer(devices=[card, card])`` on BERT-base at seq 512
   (``phase_serve_replicas``): one graph a bucket a replica, batches
   alternating, rows bitwise a one-replica server's, no capture in
   traffic, a swap reaching both replicas;
13. times each kernel (CUDA-graph replay) at the bert512 step's shapes
   against its plain version, its PyTorch library yardstick and its bound
   (the LayerNorm backward against aten's, also at the MLM head's rows;
   the two forward kernels also at a served bucket-8 forward's shapes;
   the flash forward and backward also at head dim 128, SDPA also without
   a mask where every key is valid), dense against flash attention
   at seq 128 and 512, dense against flash forward plus backward at
   seq 64, 128, 256 and 512, and the GPT path's LayerNorm at (8, 768)
   and causal flash forward at (1, 12, 256, 512 or 1024, 64), the
   int8 path's LayerNorm at (8, 768) fp32 and the flash forward's fp32
   form at the int8 BERT and GPT shapes, and the six kernels of the GPT-2
   training step at its shapes (``phase_gpt_train_timing``: LayerNorm
   forward and backward at (8192, 768), the causal flash forward with the
   lse and backward at (8, 12, 1024, 64), softmax-xent forward and backward
   at (8192, 50257)), and the two softmax-xent kernels at ResNet-50's
   (128, 1000) bf16 logits (``phase_resnet_timing``), the LayerNorm
   forward and backward at the NMT step's (2048, 512) and softmax-xent at
   the LSTM's (1120, 10000) and the NMT's (2048, 32000) bf16 logits
   (``phase_a11_timing``), each first held to its plain version;
14. breaks one serving forward at the largest bucket down (host wall, the
    executor's whole dispatch, a new thread's first dispatches, kernel time
    by class from torch.profiler, hence the device's idle share), then one
    bert512 step (kernel time by class, the LayerNorm backward and the
    optimizer step, the idle share), then the GPT-2 training step the
    same way, with Adam, SGD and LAMB (the optimizer range's device time
    of each on one line), and through ``dist.attach`` at ZeRO 0 and 1
    (the exchange's ranges' host and device time), then a GPT prefill at bucket 512 and
    a decode step of 8 slots, through its graph and eagerly, bf16 and
    int8, then the int8 BERT bucket-8 forward, then a speculative tick
    with NGramDraft, a 2-layer draft's round and tick, and a chunk tick,
    the ResNet-50 step (cuDNN's convolutions, BatchNorm, relu and the
    residual add, pooling, layout transforms, SGD's foreach, the
    softmax-xent kernels), the LSTM, SSD-512 and NMT steps, and times the
    bert512 step once more. The profiler windows come last: after one, an
    eager step's host wall may not return to what it was;
15. runs A.15's image half and A.16's observability (``run_slice20``):
    the machine's JPEG decoders (``phase_image_probe``); each fixture
    record's decode against the JAX package's (sha256) and a planted Cb/Cr
    swap (``phase_image_decode``); ResNet-50 fed 8 batches of 128 by
    ``ImageRecordIter`` over 1024 records repacked from the fixture's JPEGs
    (the fixture's own first batch equal to its digest by this machine's
    route, the first loss bit for bit the directly fed step's, 1 + 1
    softmax-xent launches a step, no CUDA allocation to decode and augment
    an image; ``phase_image_record_resnet``), then by
    ``ImageRecordDataset``, the vision transforms and ``DataLoader(pin_memory
    =True)`` at 0, 4 thread and 2 process workers, byte for byte the CPU
    loader's (``phase_vision_loader``); SSD-512 fed 10 batches of 32 by
    ``ImageDetRecordIter(rand_crop, rand_pad, rand_mirror,
    label_pad_width=8)`` (``phase_image_det_ssd``); BERT-base and GPT-2
    small served with ``metrics_port=0``: the scrape against ``stats()``,
    the request traces, the retrace watchdog around a planted retune, the
    profiler's trace against the launch counters, the TTFT count
    (``phase_observability``).

It prints the card's name and power limit and one JSON line of kernel
records, and ends with ``{"ok": true, "device": {...}}``. Any failed phase
ends the run with a nonzero exit. Without a CUDA device, or outside a
checkout, it exits nonzero and prints no result.
"""
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np

SEQ = 512
BUCKETS = (1, 4, 8)
N_REQUESTS = 16
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor-core FLOP/s, fp32
# FLOP/s outside the tensor cores, HBM3 bytes/s
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
# TF32 on the tensor cores; 3xTF32 (three TF32 products for one product
# close to fp32: the flash forward's fp32 form) runs at a third of it, the
# card's fastest fp32-accurate rate
PEAK_TF32 = 495e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BYTES = 3.35e12
# a kernel against its plain version, elementwise: |kernel - plain| <=
# atol + rtol * |plain| + mtol * mag. LayerNorm, bf16: rtol 2**-6 is two
# bf16 steps at any magnitude, atol 1e-3 two steps at |y| ~ 0.06; fp32: a
# few fp32 steps of a reordered sum. Flash: both sides round each p to
# bf16 (relative error <= 2**-8) at different running maxima, so the sum
# p @ v may differ by 2**-7 * mag, mag = (p @ |v|) / l, the plain version
# on |v|; each output's own rounding adds a step of |plain|
BF16_TOL = (1e-3, 2.0 ** -6, 0.0)
FP32_TOL = (1e-5, 1e-5, 0.0)
FLASH_TOL = (1e-5, 2.0 ** -6, 2.0 ** -7)
# flash logsumexp, fp32 row statistics, absolute
LSE_TOL = 1e-3
# served BERT rows against a direct forward (bf16 through 12 layers)
MODEL_TOL = 0.1
# softmax-xent loss and lse: fp32 row statistics, a reordered sum and the
# card's expf against torch's exp, a few fp32 steps at |loss| ~ 10. dx is
# rounded once to the logits' dtype from fp32 values a few fp32 steps
# apart: one bf16 step (< 2**-7 relative) at most
XENT_TOL = (1e-5, 1e-5, 0.0)
XENT_DX_TOL = {"bfloat16": (1e-12, 2.0 ** -7, 0.0),
               "float32": (1e-12, 1e-5, 0.0)}
# flash dq, dk, dv: each output is rounded once to bf16 (one step, < 2**-7
# of |plain|); both sides round each term p or ds to bf16 from fp32 values
# a few fp32 steps apart, which moves the sum by at most 2**-8 of the sum of
# the terms' sizes, mag: scale |ds| |k| (dq), scale |ds|^T |q| (dk) and
# p^T |dO| (dv), from the plain version
FLASH_BWD_TOL = (1e-5, 2.0 ** -7, 2.0 ** -8)
# LayerNorm backward: dx is rounded once to x's dtype (one step of |plain|:
# 2**-7 in bf16) from fp32 values whose row means were summed in another
# order, which moves them by a few fp32 steps of the terms' size, mag =
# rstd (|t| + mean |t| + |xhat| mean |t xhat|) (layernorm_bwd_magnitudes).
# dgamma and dbeta sum the rows in another order: some tens of fp32 steps
# of the sum of the terms' sizes, mag = sum |dy xhat| or sum |dy|; a 1 %
# error of dgamma reads far above it (tests/test_torch_port_smoke_tolerance)
LN_BWD_DX_TOL = {"bfloat16": (1e-12, 2.0 ** -7, 1e-5),
                 "float32": (1e-12, 1e-5, 1e-5)}
LN_BWD_PARAM_TOL = (1e-12, 1e-5, 1e-5)
# the training step with the kernels against the same step with the plain
# versions: the loss (about 11 at random weights) and each parameter's
# gradient in relative L2 norm, after bf16 through 12 layers both ways
# (honest readings 0.012-0.014, on the position embedding; the run checks
# that planted faults read above it, PLANTED_FAULTS)
STEP_LOSS_TOL = 1e-2
STEP_GRAD_TOL = 2e-2
VOCAB = 30522
GPT_VOCAB = 50257
# bench.py's two BERT-base pretraining modes: bert512 (the main path,
# BERT phase 2) and bert (the headline)
BERT512 = {"batch": 16, "seq": 512, "masked": 80}
BERT128 = {"batch": 64, "seq": 128, "masked": 20}
TRAIN_STEPS = 3
TIMED_STEPS = 6
# kernel launches a training step (26 LayerNorms, forward and backward:
# embeddings, 2 x 12 layers, the MLM head; 12 attention layers; MLM and
# NSP losses)
STEP_LAUNCHES = {"layernorm": 26, "layernorm_bwd": 26,
                 "flash_attention_fwd": 12,
                 "flash_attention_bwd": 12, "softmax_xent_fwd": 2,
                 "softmax_xent_bwd": 2}
# profiler ranges whose kernels are torch ops, so the profiler gives them
# device time; kernels launched from the extension are not
TORCH_OP_RANGES = ("mxnet_tpu_torch::optimizer_step",
                   "mxnet_tpu_torch::dist_bucket_launch",
                   "mxnet_tpu_torch::dist_finish",
                   "mxnet_tpu_torch::zero_gather")


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def time_ms(*fns, rounds=3, iters=20):
    """Device time in ms of one call of each callable: ``iters`` calls are
    captured into a CUDA graph, and a replay is timed with CUDA events, so
    the host's launch cost (larger than a small kernel's run) stays out.
    The graphs take turns for ``rounds`` rounds, so a clock change hits
    all of them, and each keeps its median round. One callable gives a
    number, several a list. No garbage collection runs inside a capture
    (it may destroy an earlier phase's graph, which invalidates it)."""
    import torch
    from mxnet_tpu_torch.serve.step_graph import collector_paused

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture
        for fn in fns:
            for _ in range(3):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        graph = torch.cuda.CUDAGraph()
        with collector_paused(), torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graphs.append(graph)
    times = [[] for _ in fns]
    for _ in range(rounds):
        for graph, out in zip(graphs, times):
            graph.replay()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) / iters)
    del graphs
    torch.cuda.empty_cache()
    med = [float(np.median(t)) for t in times]
    return med[0] if len(fns) == 1 else med


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def held(got, ref, tol, what, mag=None):
    """Check ``|got - ref| <= atol + rtol * |ref| + mtol * mag`` everywhere
    (``mag`` defaults to 0); print and return the reading: max abs error,
    max |ref| and the worst ratio of error to its limit (at most 1 to
    pass)."""
    import torch

    reading = error_reading(got, ref, tol, what, mag)
    check(bool(torch.isfinite(got).all()), "%s: non-finite output" % what)
    check(reading["worst_ratio"] <= 1.0,
          "%s: kernel disagrees with its plain version" % what)
    return reading


def error_reading(got, ref, tol, what, mag=None):
    """:func:`held`'s reading, printed, without its check (a planted
    fault's)."""
    atol, rtol, mtol = tol
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    limit = atol + rtol * ref.abs()
    if mag is not None:
        limit = limit + mtol * mag.float()
    reading = {"case": what, "max_abs_err": float(err.max()),
               "max_abs_plain": float(ref.abs().max()),
               "worst_ratio": float((err / limit).max()),
               "atol": atol, "rtol": rtol, "mtol": mtol}
    print("%s: max |kernel - plain| %.3g, max |plain| %.3g, worst error/limit "
          "%.3f (limit %g + %g |plain| + %g mag)" % (
              what, reading["max_abs_err"], reading["max_abs_plain"],
              reading["worst_ratio"], atol, rtol, mtol), flush=True)
    return reading


def kernel_counters():
    """{name: the wrapper whose ``launches`` counts that kernel}."""
    from mxnet_tpu_torch.ops.cuda import launch_counters

    return launch_counters()


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {name: fn.launches for name, fn in kernel_counters().items()}


class plain_versions:
    """Within the block, every kernel op's implementation (the entries of
    ``ops.cuda.IMPLS``, which the ``torch.library`` ops call) is its plain
    version, so the model runs without the kernels. ``faults`` names a
    wrapper whose implementation is another function instead (a planted
    fault); a fault of ``flash_attention`` also takes the place of its fp32
    form, as the public wrapper hands fp32 operands to it."""

    def __init__(self, **faults):
        self.faults = dict(faults)
        if "flash_attention" in faults:
            self.faults.setdefault("flash_attention_f32",
                                   faults["flash_attention"])

    def __enter__(self):
        from mxnet_tpu_torch.ops.cuda import IMPLS
        from mxnet_tpu_torch.ops.cuda import flash_attention as fa
        from mxnet_tpu_torch.ops.cuda import layernorm as ln
        from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

        def flash_plain(q, k, v, **kw):
            return fa.flash_attention_plain(q, k, v, **kw)

        def flash_bwd_plain(q, k, v, do, lse, delta, **kw):
            return fa.flash_attention_bwd_plain(q, k, v, do, lse, delta,
                                                **kw)

        self._saved = dict(IMPLS)
        for name, plain in (
                ("fused_layernorm", ln.layernorm_plain),
                ("fused_layernorm_bwd", ln.layernorm_bwd_plain),
                ("flash_attention", flash_plain),
                ("flash_attention_f32", flash_plain),
                ("flash_attention_bwd", flash_bwd_plain),
                ("softmax_xent_fwd", sx.softmax_xent_fwd_plain),
                ("softmax_xent_bwd", sx.softmax_xent_bwd_plain)):
            IMPLS[name] = self.faults.get(name, plain)
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops.cuda import IMPLS

        IMPLS.update(self._saved)


def phase_build():
    from mxnet_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    _build.extension(verbose=True)
    print("build: %.1f s (%s)" % (time.perf_counter() - t0, _build.BUILD_DIR),
          flush=True)


def _ln_inputs(dev, g, R, C, dtype, offset=0):
    """x (R, C) in ``dtype`` (starting ``offset`` elements into its storage,
    so a nonzero offset leaves it off 16-byte alignment), gamma and beta
    (C,) fp32."""
    import torch

    flat = (torch.randn(R * C + offset, device=dev, generator=g) * 2
            + 0.5).to(dtype)
    x = flat[offset:].view(R, C)
    return (x, torch.randn(C, device=dev, generator=g),
            torch.randn(C, device=dev, generator=g))


def layernorm_bwd_magnitudes(x, gamma, dy, eps):
    """The sizes of the terms whose rounding the backward kernel's outputs
    carry: rstd (|t| + mean |t| + |xhat| mean |t xhat|) for dx, t = dy
    gamma, and the sums over rows of |dy xhat| and |dy| for dgamma and
    dbeta, from fp32."""
    xf, dyf = x.float(), dy.float()
    m = xf.mean(dim=-1, keepdim=True)
    rstd = ((xf - m).square().mean(dim=-1, keepdim=True) + eps).rsqrt()
    xhat = (xf - m) * rstd
    t = (dyf * gamma.float()).abs()
    mdx = rstd * (t + t.mean(dim=-1, keepdim=True)
                  + xhat.abs() * (t * xhat.abs()).mean(dim=-1, keepdim=True))
    return mdx, (dyf * xhat).abs().sum(dim=0), dyf.abs().sum(dim=0)


def phase_layernorm(dev):
    """The LayerNorm forward and backward kernels against their plain
    versions. Forward: the bert512 step's two shapes first (16 * 512 rows;
    the MLM head's 16 * 80), a served bucket-8 forward's, fp32, a GPT decode
    step's 8 rows at eps 1e-5 (the CTA form), a C that is not a multiple of
    8, rows above the register forms (the loop form), an x off 16-byte
    alignment, the fp32 rows the int8 paths give it (BERT's bucket-8
    forward, GPT's prefills at buckets 256-1024); in bf16 the register
    forms give a row the same output at 8 rows as at 4096. Backward: the step's two shapes, the decode rows, fp32, and
    the loop form's rows; dgamma and dbeta bit-equal over two calls, and a
    row's dx the same at 8 rows as at 1280."""
    import torch
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    g = torch.Generator(device=dev).manual_seed(SEED)
    bf16, fp32 = torch.bfloat16, torch.float32
    fwd = []
    for (R, C), dtype, eps, offset in (((8192, 768), bf16, 1e-12, 0),
                                       ((1280, 768), bf16, 1e-12, 0),
                                       ((4096, 768), bf16, 1e-12, 0),
                                       ((1000, 1000), fp32, 1e-5, 0),
                                       ((8, 768), bf16, 1e-5, 0),
                                       ((8, 1000), fp32, 1e-5, 0),
                                       ((2048, 770), bf16, 1e-5, 0),
                                       ((8, 770), bf16, 1e-5, 0),
                                       ((4096, 8192), bf16, 1e-5, 0),
                                       ((8, 8192), bf16, 1e-5, 0),
                                       ((8, 16384), bf16, 1e-5, 0),
                                       ((1024, 768), bf16, 1e-12, 1),
                                       # the int8 paths' fp32 rows: BERT's
                                       # bucket-8 forward, GPT's prefills
                                       ((4096, 768), fp32, 1e-12, 0),
                                       ((1024, 768), fp32, 1e-5, 0),
                                       ((512, 768), fp32, 1e-5, 0),
                                       ((256, 768), fp32, 1e-5, 0)):
        x, gamma, beta = _ln_inputs(dev, g, R, C, dtype, offset)
        y = ln.fused_layernorm(x, gamma, beta, eps)
        torch.cuda.synchronize()
        ref = ln.layernorm_plain(x, gamma, beta, eps)
        check(y.dtype == dtype and y.shape == x.shape, "layernorm shape/dtype")
        fwd.append(held(y, ref, BF16_TOL if dtype == bf16 else FP32_TOL,
                        "layernorm %s %s eps %g%s" % (
                            (R, C), str(dtype)[6:], eps,
                            " x at a %d-element offset" % offset
                            if offset else "")))
        if (R, C) == (4096, 768) and dtype == bf16:
            # 8 rows take the CTA form, 4096 the warp form
            check(torch.equal(ln.fused_layernorm(x[:8].contiguous(), gamma,
                                                 beta, eps), y[:8]),
                  "layernorm: a row's output at 8 rows differs from 4096")
    bwd = []
    for (R, C), dtype, eps in (((8192, 768), bf16, 1e-12),
                               ((1280, 768), bf16, 1e-12),
                               ((8, 768), bf16, 1e-5),
                               ((1000, 1000), fp32, 1e-5),
                               ((2048, 770), bf16, 1e-5),
                               ((4096, 8192), bf16, 1e-5),
                               ((8, 8192), bf16, 1e-5)):
        x, gamma, _ = _ln_inputs(dev, g, R, C, dtype)
        dy = torch.randn(R, C, device=dev, generator=g).to(dtype)
        dx, dg, db = ln.fused_layernorm_bwd(x, gamma, dy, eps)
        dx2, dg2, db2 = ln.fused_layernorm_bwd(x, gamma, dy, eps)
        torch.cuda.synchronize()
        ref = ln.layernorm_bwd_plain(x, gamma, dy, eps)
        mags = layernorm_bwd_magnitudes(x, gamma, dy, eps)
        what = "layernorm bwd %s %s eps %g" % ((R, C), str(dtype)[6:], eps)
        check(dx.dtype == dtype and dx.shape == x.shape
              and dg.dtype == db.dtype == fp32 and dg.shape == db.shape
              == gamma.shape, "%s: shape/dtype" % what)
        reading = {n: held(got, want, tol, "%s %s" % (what, n), mag)
                   for n, got, want, tol, mag in (
                       ("dx", dx, ref[0], LN_BWD_DX_TOL[str(dtype)[6:]],
                        mags[0]),
                       ("dgamma", dg, ref[1], LN_BWD_PARAM_TOL, mags[1]),
                       ("dbeta", db, ref[2], LN_BWD_PARAM_TOL, mags[2]))}
        check(torch.equal(dg, dg2) and torch.equal(db, db2),
              "%s: dgamma/dbeta differ between two calls" % what)
        check(torch.equal(dx, dx2), "%s: dx differs between two calls" % what)
        if (R, C) == (1280, 768):
            # the warp form at both row counts: one CTA at 8 rows, 160
            check(torch.equal(ln.fused_layernorm_bwd(
                x[:8].contiguous(), gamma, dy[:8].contiguous(), eps)[0],
                dx[:8]), "layernorm bwd: a row's dx at 8 rows differs from "
                "1280")
        bwd.append(reading)
    print("layernorm bwd: dx, dgamma and dbeta bit-equal over two calls at "
          "every shape", flush=True)
    return fwd, bwd


def _qkv(dev, g, B, H, T, D, dtype=None):
    import torch

    return [torch.randn(B, H, T, D, device=dev, generator=g)
            .to(dtype or torch.bfloat16) for _ in range(3)]


def flash_magnitude(q, k, v, vl=None, causal=False, scale=None):
    """(p @ |v|) / l of each output element, from the plain version on |v|:
    the size of the sum whose terms the kernel rounds."""
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

    return flash_attention_plain(q, k, v.abs(), kv_valid_len=vl,
                                 causal=causal, scale=scale)


def phase_flash(dev):
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rng = np.random.RandomState(SEED)
    readings = []
    cases = [
        # name, (B, H, T, D), causal, valid lengths, lse; the bert512
        # step's call first
        ("bert512 all valid", (16, 12, 512, 64), False, np.full(16, 512),
         True),
        ("bert-512 vl", (8, 12, 512, 64), False,
         rng.choice([0, 1, 37, 256, 512], 8), False),
        ("causal", (2, 12, 512, 64), True, None, False),
        ("causal vl lse", (2, 12, 512, 64), True, np.array([300, 512]), True),
        ("lse", (4, 12, 512, 64), False, np.array([0, 1, 256, 512]), True),
        ("ragged T=200", (3, 4, 200, 64), False, np.array([200, 0, 77]), True),
        ("D=128", (2, 8, 256, 128), False, np.array([256, 100]), True),
        # 30 K/V tiles through the ring into each row
        ("T=2048 vl lse", (1, 4, 2048, 64), False, np.array([1900]), True),
        # a 64-multiple that is not a 128-multiple: the last CTA's second
        # warpgroup has no rows
        ("causal vl T=192", (3, 4, 192, 64), True, np.array([192, 100, 0]),
         False),
        ("T=1", (2, 3, 1, 64), False, None, True),
        ("D=128 causal lse", (2, 6, 512, 128), True, None, True),
    ]
    for name, (B, H, T, D), causal, vl, lse in cases:
        q, k, v = _qkv(dev, g, B, H, T, D)
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        kw = {"causal": causal, "kv_valid_len": vlt, "return_lse": lse}
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        ref = flash_attention_plain(q, k, v, **kw)
        what = "flash %s %s causal=%s vl=%s" % (
            name, (B, H, T, D), causal, None if vl is None else
            [int(n) for n in vl])
        if not readings:
            # the bert512 case again on the same inputs: the forward has no
            # atomics and sums in a fixed order, so the runs agree bit for bit
            again = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            runs = [r if lse else (r,) for r in (got, again)]
            same = all(torch.equal(a, b) for a, b in zip(*runs))
            print("%s: run 2 identical to run 1: %s" % (what, same),
                  flush=True)
            check(same, "%s: two runs on the same inputs differ" % what)
        if lse:
            (got, got_lse), (ref, ref_lse) = got, ref
            # fp32 row statistics; rows without a valid key hold -1e30
            lse_err = max_err(got_lse, ref_lse)
            print("%s: max |lse - plain lse| %.3g (limit %g)"
                  % (what, lse_err, LSE_TOL))
            check(lse_err <= LSE_TOL, "%s: lse disagrees" % what)
        check(got.shape == q.shape and got.dtype == torch.bfloat16,
              "%s: shape/dtype" % what)
        readings.append(held(got, ref, FLASH_TOL, what,
                             flash_magnitude(q, k, v, vlt, causal)))
        if vl is not None:
            for b in np.flatnonzero(np.asarray(vl) == 0):
                check(not bool(got[b].any()), "%s: vl=0 row not zero" % what)
    # a negative scale: the kernel scales the scores before their max
    q, k, v = _qkv(dev, g, 2, 4, 256, 64)
    got = flash_attention(q, k, v, scale=-0.125)
    torch.cuda.synchronize()
    readings.append(held(got, flash_attention_plain(q, k, v, scale=-0.125),
                         FLASH_TOL, "flash scale -0.125 (2, 4, 256, 64)",
                         flash_magnitude(q, k, v, scale=-0.125)))
    return readings


# the flash forward's fp32 form against its plain version: both take fp32
# products and an fp32 softmax, in different orders (the kernel's online
# rescale, expf against torch.exp), so they differ by some fp32 steps of
# the sum of the terms' sizes, mag = (p @ |v|) / l, and of |plain|
FLASH_F32_TOL = (1e-6, 1e-5, 1e-5)


def tf32_rounded(x):
    """fp32 ``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``): the operands of one TF32 product,
    made in torch with no global flag flipped."""
    import torch

    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def phase_flash_f32(dev):
    """The flash forward's fp32 form (the quantized models' attention)
    against its plain version: the int8 BERT bucket-8 forward's shape
    first, twice (bit-identical), the int8 GPT prefills' causal shapes at
    buckets 256, 512 and 1024, the int8 BERT forwards at buckets 1 (split,
    each served valid length; the one over 256 keys, whose second split
    the combine pass merges, twice) and 4 (unsplit) with the served valid
    lengths, then the tile edges and the split key range
    (a grid under a wave: the causal prefill at 512 twice, bit-identical).
    Then a planted reading: the plain version on TF32-rounded operands must
    read above the limit that 3xTF32 is held to."""
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        F32_TILES, _sms, f32_tile, flash_attention, flash_attention_f32,
        flash_attention_plain, flash_f32_splits)

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    rng = np.random.RandomState(SEED + 21)
    served_vl = _bert_requests()[2]
    readings = []
    # name, (B, H, T, D), causal, valid lengths, lse, the key range split,
    # run twice
    cases = [
        ("bert int8 vl", (BUCKETS[-1], 12, SEQ, 64), False,
         rng.choice([0, 1, 37, 256, 512], BUCKETS[-1]), False, False, True),
        ("gpt int8 prefill", (1, 12, 256, 64), True, None, False, True,
         False),
        ("gpt int8 prefill", (1, 12, 512, 64), True, None, False, True, True),
        ("gpt int8 prefill", (1, 12, 1024, 64), True, None, False, True,
         False),
    ] + [
        ("bert int8 bucket %d vl" % (b - a), (b - a, 12, SEQ, 64), False,
         served_vl[a:b], False, b - a == 1, b - a == 1 and served_vl[a] > 256)
        for a, b in BERT_INT8_GROUPS if b - a < BUCKETS[-1]
    ] + [
        ("ragged T=200", (3, 4, 200, 64), False, np.array([200, 0, 77]), True,
         True, False),
        ("T=2048 vl lse", (1, 4, 2048, 64), False, np.array([1900]), True,
         True, False),
        ("causal vl T=192", (3, 4, 192, 64), True, np.array([192, 100, 0]),
         False, True, False),
        ("T=1", (2, 3, 1, 64), False, None, True, False, False),
        ("D=128 causal vl lse", (2, 6, 512, 128), True, np.array([300, 512]),
         True, True, False),
        # the split key range: batch-1 causal prefills, one CTA's run of
        # key tiles ending inside the sequence; head dim 128; vl 1 and 0
        ("split causal", (1, 12, 640, 64), True, None, True, True, False),
        ("split causal", (1, 12, 700, 64), True, None, True, True, False),
        ("split causal", (1, 4, 2048, 64), True, None, False, True, False),
        ("split causal", (1, 3, 2000, 64), True, None, True, True, False),
        ("split D=128 causal vl", (1, 12, 512, 128), True, np.array([300]),
         True, True, False),
        ("split vl 1 and 0", (3, 4, 512, 64), False, np.array([1, 0, 333]),
         True, True, False),
    ]
    before = flash_attention.launches
    sms = _sms(dev)
    # the tile the built kernel reports (its occupancy included) is the one
    # the CPU tests of the split choice assume
    for D, tile in F32_TILES.items():
        print("fp32 flash tile at head dim %d: %s (query rows, keys, CTAs an "
              "SM); %d SMs" % (D, f32_tile(D), sms), flush=True)
        check(f32_tile(D) == tile, "fp32 flash tile at head dim %d is %s, "
              "F32_TILES says %s" % (D, f32_tile(D), tile))
    for name, (B, H, T, D), causal, vl, lse, split, twice in cases:
        splits, chunk = flash_f32_splits(B * H, T, T, causal, sms, D,
                                         tile=f32_tile(D))
        check((splits > 1) == split, "fp32 flash %s %s: %d splits, %s "
              "expected" % (name, (B, H, T, D), splits,
                            "more" if split else "1"))
        q, k, v = _qkv(dev, g, B, H, T, D, torch.float32)
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        kw = {"causal": causal, "kv_valid_len": vlt, "return_lse": lse}
        n0 = flash_attention_f32.launches
        got = flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        check(flash_attention_f32.launches == n0 + 1,
              "fp32 flash: the fp32 form did not launch")
        ref = flash_attention_plain(q, k, v, **kw)
        what = "flash fp32 %s %s causal=%s vl=%s, %d splits of <= %d key " \
            "tiles" % (name, (B, H, T, D), causal, None if vl is None else
                       [int(n) for n in vl], splits, chunk)
        if twice:
            again = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            same = torch.equal(got, again)
            print("%s: run 2 identical to run 1: %s" % (what, same),
                  flush=True)
            check(same, "%s: two runs on the same inputs differ" % what)
        if lse:
            (got, got_lse), (ref, ref_lse) = got, ref
            lse_err = max_err(got_lse, ref_lse)
            print("%s: max |lse - plain lse| %.3g (limit %g)"
                  % (what, lse_err, LSE_TOL))
            check(lse_err <= LSE_TOL, "%s: lse disagrees" % what)
            if vl is not None:
                for b in np.flatnonzero(np.asarray(vl) == 0):
                    check(bool((got_lse.view(B, H, T)[b] == -1e30).all()),
                          "%s: vl=0 lse not -1e30" % what)
        check(got.shape == q.shape and got.dtype == torch.float32,
              "%s: shape/dtype" % what)
        readings.append(held(got, ref, FLASH_F32_TOL, what,
                             flash_magnitude(q, k, v, vlt, causal)))
        if vl is not None:
            for b in np.flatnonzero(np.asarray(vl) == 0):
                check(not bool(got[b].any()), "%s: vl=0 row not zero" % what)
    q, k, v = _qkv(dev, g, 2, 4, 256, 64, torch.float32)
    got = flash_attention(q, k, v, scale=-0.125)
    torch.cuda.synchronize()
    readings.append(held(got, flash_attention_plain(q, k, v, scale=-0.125),
                         FLASH_F32_TOL, "flash fp32 scale -0.125 "
                         "(2, 4, 256, 64)",
                         flash_magnitude(q, k, v, scale=-0.125)))
    # a view that starts off a 16-byte boundary is refused, not read
    flat = torch.zeros(2 * 4 * 256 * 64 + 1, device=dev)
    bad = flat[1:].view(2, 4, 256, 64)
    try:
        flash_attention(bad, bad, bad)
        check(False, "fp32 flash took a misaligned q")
    except ValueError:
        pass
    check(flash_attention.launches == before,
          "fp32 operands launched the bf16 flash kernel")
    # planted: one TF32 product instead of three, at the int8 BERT bucket-8
    # shape, must read above the limit
    q, k, v = _qkv(dev, g, BUCKETS[-1], 12, SEQ, 64, torch.float32)
    vlt = torch.tensor(cases[0][3], dtype=torch.int32, device=dev)
    ref = flash_attention_plain(q, k, v, kv_valid_len=vlt)
    planted = error_reading(
        flash_attention_plain(tf32_rounded(q), tf32_rounded(k),
                              tf32_rounded(v), kv_valid_len=vlt), ref,
        FLASH_F32_TOL, "planted fault: flash fp32 plain on TF32-rounded "
        "operands %s" % ((BUCKETS[-1], 12, SEQ, 64),),
        flash_magnitude(q, k, v, vlt))
    check(planted["worst_ratio"] > 1.0,
          "the fp32 flash limit misses one TF32 product for three")
    readings[0]["planted_tf32_worst_ratio"] = planted["worst_ratio"]
    return readings


def phase_xent(dev):
    """The softmax-xent forward and backward kernels against their plain
    versions; the first case is the main path's MLM head. The last two are
    a padded vocabulary sliced to V (rows ``pad`` elements wider than V, read
    at their own stride, not copied)."""
    import torch
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    readings = []
    for (R, V), dtype, pad in (((1280, VOCAB), torch.bfloat16, 0),
                               ((16, 2), torch.bfloat16, 0),
                               ((37, 1000), torch.float32, 0),
                               ((64, GPT_VOCAB), torch.bfloat16, 7),
                               ((37, 1000), torch.float32, 3)):
        x = (torch.randn(R, V + pad, device=dev, generator=g)
             * 3).to(dtype)[:, :V]
        check((pad > 0) != x.is_contiguous(), "softmax-xent: the padded "
              "case's logits are a strided view")
        labels = torch.randint(0, V, (R,), device=dev, generator=g,
                               dtype=torch.int32)
        labels[0] = V - 1  # a label in the last column
        dy = torch.randn(R, device=dev, generator=g)
        what = "softmax-xent (%d, %d) %s%s" % (
            R, V, str(dtype)[6:], " rows %d apart" % (V + pad) if pad else "")
        loss, lse = sx.softmax_xent_fwd(x, labels)
        torch.cuda.synchronize()
        ref_loss, ref_lse = sx.softmax_xent_fwd_plain(x, labels)
        fwd = held(loss, ref_loss, XENT_TOL, what + " loss")
        held(lse, ref_lse, XENT_TOL, what + " lse")
        dx = sx.softmax_xent_bwd(x, labels, ref_lse, dy)
        torch.cuda.synchronize()
        ref_dx = sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy)
        check(dx.dtype == dtype and dx.shape == x.shape,
              "%s: dx shape/dtype" % what)
        bwd = held(dx, ref_dx, XENT_DX_TOL[str(dtype)[6:]], what + " dx")
        readings.append({"fwd": fwd, "bwd": bwd})
    return readings


def flash_bwd_magnitudes(q, k, v, do, lse, delta, vl=None, causal=False):
    """The sizes of the sums whose terms the dq, dk and dv kernels round:
    scale |ds| |k|, scale |ds|^T |q| and p^T |dO|, from the plain version."""
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_p_ds_plain

    scale = 1.0 / q.shape[-1] ** 0.5
    p, ds = flash_p_ds_plain(q, k, v, do, lse, delta, vl, scale, causal)
    ds = ds.abs()
    mdq = torch.matmul(ds, k.float().abs()) * scale
    mdk = torch.matmul(ds.transpose(-1, -2), q.float().abs()) * scale
    mdv = torch.matmul(p.transpose(-1, -2), do.float().abs())
    return mdq, mdk, mdv


def flash_bwd_inputs(dev, g, B, H, T, D, vl=None, causal=False):
    """q, k, v, dO (bf16), and the lse and delta the backward takes, from
    the plain forward."""
    import torch
    from mxnet_tpu_torch.ops.cuda.flash_attention import flash_attention_plain

    q, k, v, do = [torch.randn(B, H, T, D, device=dev, generator=g)
                   .to(torch.bfloat16) for _ in range(4)]
    o, lse = flash_attention_plain(q, k, v, kv_valid_len=vl, causal=causal,
                                   return_lse=True)
    delta = (o.float() * do.float()).sum(dim=-1)
    return q, k, v, do, lse, delta


def phase_flash_bwd(dev):
    """The flash backward kernel against its plain version; the first case
    is the main path's shape with every key valid. Rows of dk and dv past an
    example's valid length must be exactly zero, and dq of a vl = 0 example
    too. The bert512 case runs again on the same inputs: dq's partial sums
    land in no fixed order, and the two runs must agree within the same
    limit."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    readings = []
    cases = [
        # name, (B, H, T, D), causal, valid lengths
        ("bert512 all valid", (16, 12, 512, 64), False, None),
        ("vl", (8, 12, 512, 64), False, [512, 0, 256, 1, 37, 300, 511, 64]),
        ("causal", (2, 12, 512, 64), True, None),
        ("causal vl", (2, 12, 512, 64), True, [300, 512]),
        ("ragged T=200", (3, 4, 200, 64), False, [200, 0, 77]),
        ("D=128", (2, 8, 256, 128), False, [256, 100]),
        ("D=128 causal ragged", (2, 4, 200, 128), True, [200, 150]),
        # 30 key tiles of 64 add into each dq row
        ("T=2048 vl", (1, 4, 2048, 64), False, [1900]),
    ]
    for name, (B, H, T, D), causal, vl in cases:
        vlt = None if vl is None else torch.tensor(vl, dtype=torch.int32,
                                                   device=dev)
        q, k, v, do, lse, delta = flash_bwd_inputs(dev, g, B, H, T, D, vlt,
                                                   causal)
        args = (q, k, v, do, lse, delta)
        kw = {"kv_valid_len": vlt, "causal": causal}
        dq, dk, dv = fa.flash_attention_bwd(*args, **kw)
        torch.cuda.synchronize()
        ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(*args, **kw)
        mdq, mdk, mdv = flash_bwd_magnitudes(*args, vl=vlt, causal=causal)
        what = "flash bwd %s %s causal=%s vl=%s" % (name, (B, H, T, D),
                                                    causal, vl)
        for t, ref in ((dq, q), (dk, k), (dv, v)):
            check(t.shape == ref.shape and t.dtype == torch.bfloat16,
                  "%s: shape/dtype" % what)
        reading = {"dq": held(dq, ref_dq, FLASH_BWD_TOL, what + " dq", mdq),
                   "dk": held(dk, ref_dk, FLASH_BWD_TOL, what + " dk", mdk),
                   "dv": held(dv, ref_dv, FLASH_BWD_TOL, what + " dv", mdv)}
        for b, n in enumerate(vl or []):
            check(not (bool(dk[b, :, n:].any()) or bool(dv[b, :, n:].any())),
                  "%s: dk/dv rows past vl=%d not exactly zero" % (what, n))
            if n == 0:
                check(not bool(dq[b].any()), "%s: vl=0 dq not zero" % what)
        if not readings:
            # the same inputs again: only the order of dq's sums differs
            dq2, dk2, dv2 = fa.flash_attention_bwd(*args, **kw)
            torch.cuda.synchronize()
            check(torch.equal(dk, dk2) and torch.equal(dv, dv2),
                  "%s: dk/dv differ between two runs" % what)
            rerun = held(dq2, dq, FLASH_BWD_TOL, what + " dq run 2 vs run 1",
                         mdq)
            reading["dq_rerun"] = rerun
            print("%s: max |dq run 2 - dq run 1| %.3g; %d of %d elements "
                  "differ" % (what, rerun["max_abs_err"],
                              int((dq2 != dq).sum()), dq.numel()), flush=True)
        readings.append(reading)
    print("flash bwd: dk and dv rows past every valid length are exactly 0",
          flush=True)
    return readings


def _bert_requests():
    rng = np.random.RandomState(SEED)
    vl = np.linspace(1, SEQ, N_REQUESTS).astype(np.int32)
    rng.shuffle(vl)
    tok = rng.randint(0, 30522, (N_REQUESTS, SEQ)).astype(np.int32)
    tt = (np.arange(SEQ)[None, :] >= vl[:, None] // 2).astype(np.int32)
    return tok, tt, vl


# the int8 BERT serving run's batches of _bert_requests, each filling its
# bucket (1, 4, 8, 1, 1, 1 rows): a pad row would join the per-tensor
# activation scale
BERT_INT8_GROUPS = ((0, 1), (1, 5), (5, 13), (13, 14), (14, 15), (15, 16))


def phase_serve(dev):
    """BERT-base served through ModelServer in two bursts of requests;
    returns the model, the kernel launch counts of the serving run, the
    forwards it took, the request valid lengths and the serving numbers."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    n_params = sum(p._tensor().numel()
                   for p in model.collect_params().values())
    print("bert_base: %d parameters, bf16 (norms fp32), seq %d" % (n_params,
                                                                   SEQ))
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    t0 = time.perf_counter()
    srv = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, device=dev)
    torch.cuda.synchronize()
    warm = srv.stats()
    print("server warmup (%s buckets, one CUDA graph each): %.2f s; %s"
          % (list(BUCKETS), time.perf_counter() - t0,
             {k: warm[k] for k in GRAPH_KEYS}))
    check_warm_graphs(warm, BUCKETS, "bf16 BERT server")
    tok, tt, vl = _bert_requests()

    bursts, outputs = [], []
    with srv:
        batches0 = srv.metrics.batches
        reset_counters()
        # the first burst meets a fresh dispatcher thread; the second one
        # is the steady state
        for burst in ("first", "second"):
            t0 = time.perf_counter()
            handles = [(time.perf_counter(), srv.submit(tok[i], tt[i], vl[i]))
                       for i in range(N_REQUESTS)]
            served, lat = [], []
            for t_sub, h in handles:  # in submit order, which is batch order
                served.append(h.result(timeout_s=300))
                lat.append((time.perf_counter() - t_sub) * 1e3)
            wall = time.perf_counter() - t0
            outputs.append(served)
            bursts.append({"burst": burst, "wall_ms": wall * 1e3,
                           "req_per_s": N_REQUESTS / wall,
                           "p50_ms": float(np.percentile(lat, 50)),
                           "p99_ms": float(np.percentile(lat, 99))})
            print("burst %-6s: %d requests, %.1f ms wall, %.2f req/s, p50 "
                  "%.2f ms, p99 %.2f ms" % (
                      burst, N_REQUESTS, wall * 1e3, N_REQUESTS / wall,
                      bursts[-1]["p50_ms"], bursts[-1]["p99_ms"]), flush=True)
        counts = read_counters()
        launches = {k: counts[k] for k in ("layernorm", "flash_attention_fwd")}
        forwards = srv.metrics.batches - batches0
        stats = srv.stats()
    print("served %d requests in %d forwards (graph replays), fill %.3f"
          % (2 * N_REQUESTS, forwards, stats["batch_fill_ratio"]), flush=True)
    check(stats["captures"] == warm["captures"] and stats["drops"] == 0
          and stats["replays"] == warm["replays"] + forwards,
          "bf16 BERT traffic captured a graph or ran without one: %s"
          % {k: stats[k] for k in GRAPH_KEYS})
    print("kernel launches in the serving run: %s" % launches)
    check(stats["errors"] == 0 and stats["completed"] >= 2 * N_REQUESTS,
          "serving errors: %s" % stats)
    check(forwards >= 1, "no forward dispatched")
    check(launches["layernorm"] == 25 * forwards,
          "layernorm launches %d != 25 x %d forwards"
          % (launches["layernorm"], forwards))
    check(launches["flash_attention_fwd"] == 12 * forwards,
          "flash launches %d != 12 x %d forwards"
          % (launches["flash_attention_fwd"], forwards))
    check(not any(counts[k] for k in counts if k not in launches),
          "serving launched a training kernel: %s" % counts)

    # reference 1: a direct forward of the same model on the card
    ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]
    with torch.inference_mode():
        direct = [o.float().cpu().numpy() for o in model(*ins)]
    # reference 2: the same forward with the plain versions in place of the
    # kernels (patched into the op modules for this call only)
    reset_counters()
    with plain_versions(), torch.inference_mode():
        plain = [o.float().cpu().numpy() for o in model(*ins)]
    check(not any(read_counters().values()),
          "the plain-version forward launched a kernel: %s" % read_counters())

    def real_rows(outs, i):
        """Request i's sequence rows up to its valid length, pooled, NSP."""
        n = int(vl[i])
        return outs[0][i, :n], outs[1][i], outs[2][i]

    U = model._units
    worst_served = worst_plain = 0.0
    for served in outputs:
        check(served[0][0].shape == (1, SEQ, U)
              and served[0][1].shape == (1, U)
              and served[0][2].shape == (1, 2), "served output shapes")
        stacked = [np.concatenate([s[j] for s in served]) for j in range(3)]
        for i in range(N_REQUESTS):
            for a, b in zip(real_rows(stacked, i), real_rows(direct, i)):
                check(np.isfinite(a).all(), "non-finite served output")
                worst_served = max(worst_served, float(np.abs(a - b).max()))
    for i in range(N_REQUESTS):
        for a, b in zip(real_rows(direct, i), real_rows(plain, i)):
            check(np.isfinite(a).all() and np.isfinite(b).all(),
                  "non-finite direct output")
            worst_plain = max(worst_plain, float(np.abs(a - b).max()))
    print("BERT served rows vs direct forward: max abs %.3g; direct forward "
          "with kernels vs with plain versions: max abs %.3g (tol %g)"
          % (worst_served, worst_plain, MODEL_TOL), flush=True)
    # bf16 through 12 layers, different batch compositions (GEMM shapes)
    # and different rounding points of p: two bf16 steps at |x| ~ 4
    check(worst_served <= MODEL_TOL, "served rows disagree with direct")
    check(worst_plain <= MODEL_TOL, "kernels disagree with plain versions "
          "inside the model")
    return model, launches, forwards, vl, {"bursts": bursts,
                                           "server_stats": stats}, srv


def _kernel_class(name):
    if "flash_fwd_kernel" in name or "flash_fwd_f32_" in name:
        return "flash"
    if "layernorm_" in name:
        return "layernorm"
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def phase_breakdown(dev, model):
    """Where one eager serving forward at the largest bucket spends its
    time: the host wall of the forward and of the executor's whole eager
    dispatch (pad, copy in, forward, copy out), a fresh thread's first
    dispatches, and the
    kernel time by class from torch.profiler, hence the device's idle
    share of the forward."""
    import torch

    from mxnet_tpu_torch.serve import BucketedExecutor

    B = BUCKETS[-1]
    tok, tt, vl = (a[:B] for a in _bert_requests())
    ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]

    def forward():
        with torch.inference_mode():
            model(*ins)

    forward()
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    fn, _ = model.serving_fn()
    plist = list(model.collect_params().values())
    pool = BucketedExecutor(fn, lambda: [p._tensor() for p in plist], (B,),
                            dev)

    def timed_dispatch(into):  # eager: phase_serve_graph times the graphs
        t0 = time.perf_counter()
        pool.run([tok, tt, vl], eager=True)
        into.append((time.perf_counter() - t0) * 1e3)

    # a thread's first dispatch against its later ones (the server's
    # dispatcher is a fresh thread after every start())
    per_thread = []
    worker = threading.Thread(target=lambda: [timed_dispatch(per_thread)
                                              for _ in range(3)])
    worker.start()
    worker.join()
    dispatch = []
    for _ in range(10):
        timed_dispatch(dispatch)

    prof = _profile(forward, 3)
    wall = float(np.median(walls))
    # busy time and wall from the same profiled window; the profiler's own
    # host cost lengthens that wall, so the share leans high
    out = {"bucket": B, "seq": SEQ,
           "forward_wall_ms_median": wall,
           "dispatch_wall_ms_median": float(np.median(dispatch)),
           "new_thread_dispatch_ms": per_thread,
           "kernel_ms_per_forward": prof["kernel_ms"],
           "profiled_wall_ms_per_forward": prof["profiled_wall_ms"],
           "device_idle_share": prof["device_idle_share"]}
    print("breakdown of one bucket-%d forward: host wall %.3f ms, executor "
          "dispatch %.3f ms (medians of 10); a new thread's first three "
          "dispatches %s ms" % (B, wall, out["dispatch_wall_ms_median"],
                                ["%.1f" % t for t in per_thread]), flush=True)
    print("kernel time per forward by class (torch.profiler): %s; %.3f ms "
          "busy in %.3f ms of wall under the profiler: device idle %.1f%%"
          % ({k: round(v, 4) for k, v in prof["kernel_ms"].items()},
             prof["busy_ms"], prof["profiled_wall_ms"],
             100 * out["device_idle_share"]))
    for ms, n, name in prof["top"]:
        print("  %8.4f ms  x%-4d %s" % (ms, n, name))
    check(prof["busy_ms"] > 0, "the profiler saw no kernel time")
    return out


def make_batch(rng, batch, seq, masked):
    """bench.py's ``make_batch`` in numpy: random tokens, token type 0,
    every position valid, random masked positions and labels."""
    return (rng.integers(0, VOCAB, (batch, seq)).astype(np.int32),
            np.zeros((batch, seq), np.int32),
            np.full((batch,), seq, np.float32),
            rng.integers(0, seq, (batch, masked)).astype(np.int32),
            rng.integers(0, VOCAB, (batch, masked)).astype(np.int32),
            rng.integers(0, 2, (batch,)).astype(np.int32))


class TrainStep:
    """BERT-base pretraining through the port's entry points, as a user
    writes it: ``bert_base`` in bf16 via amp, ``gluon.Trainer`` with Adam
    (lr 1e-4, wd 0.01, fp32 masters), MLM and NSP
    ``SoftmaxCrossEntropyLoss``, ``autograd.record`` / ``backward``."""

    def __init__(self, dev, recipe):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.models.bert import bert_base

        self.recipe = recipe
        self.model = bert_base(dropout=0.1, max_length=recipe["seq"])
        self.model.initialize(
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        amp.convert_hybrid_block(self.model, "bfloat16")
        self.params = list(self.model.collect_params().values())
        self.trainer = gluon.Trainer(
            self.model.collect_params(), "adam",
            {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True})
        self.mlm_loss = gluon.loss.SoftmaxCrossEntropyLoss()
        self.nsp_loss = gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.default_rng(SEED)
        self.batch = [torch.from_numpy(a).to(dev) for a in make_batch(
            rng, recipe["batch"], recipe["seq"], recipe["masked"])]

    def __call__(self, update=True):
        """One step; returns the per-sample loss (the head the backward
        starts from)."""
        from mxnet_tpu_torch import autograd

        tok, tt, vl, mp, mlm_y, nsp_y = self.batch
        with autograd.record():
            _, _, nsp, mlm = self.model(tok, tt, vl, mp)
            loss = self.mlm_loss(mlm, mlm_y) + self.nsp_loss(nsp, nsp_y)
        autograd.backward(loss)
        if update:
            self.trainer.step(self.recipe["batch"])
        return loss.detach()

    def timed(self, steps):
        """Median host wall (ms) of ``steps`` steps, each ending in a host
        readback of the loss; the losses."""
        walls, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(self().mean()))
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls)), losses


def _grads(params):
    return [p._tensor().grad.detach().clone() for p in params]


def grad_rel_l2(params, grads, ref_grads):
    """[(|g - ref| / |ref| in L2, name)] of each parameter, worst first."""
    rel = []
    for p, g, ref in zip(params, grads, ref_grads):
        num = float((g.float() - ref.float()).norm())
        den = float(ref.float().norm())
        rel.append((num / den if den > 0 else num, p.name))
    return sorted(rel, reverse=True)


def dq_last_tile_dropped(q, k, v, do, lse, delta, kv_valid_len=None,
                         scale=None, causal=False):
    """A planted fault: the plain backward with each example's last 64
    valid keys (one key tile of the dq sum at vl 512) left out of dq."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    vl = kv_valid_len if kv_valid_len is not None else torch.full(
        (q.shape[0],), k.shape[2], dtype=torch.int32, device=q.device)
    dq = fa.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                     (vl - 64).clamp(min=0), scale, causal)
    dk, dv = fa.flash_attention_dkv_plain(q, k, v, do, lse, delta,
                                          kv_valid_len, scale, causal)
    return dq, dk, dv


def dkv_last_query_tile_dropped(q, k, v, do, lse, delta, kv_valid_len=None,
                                scale=None, causal=False):
    """A planted fault: the plain backward with the last 64 query rows left
    out of the dk and dv sums."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    B, H, T, _ = q.shape
    n = T - 64
    dq = fa.flash_attention_dq_plain(q, k, v, do, lse, delta, kv_valid_len,
                                     scale, causal)
    dk, dv = fa.flash_attention_dkv_plain(
        q[:, :, :n], k, v, do[:, :, :n],
        lse.reshape(B * H, T, 1)[:, :n].contiguous(),
        delta.reshape(B, H, T)[:, :, :n], kv_valid_len, scale, causal)
    return dq, dk, dv


def layernorm_gamma_high(x, gamma, beta, eps):
    """A planted fault: the plain LayerNorm with gamma 1 % high."""
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    return ln.layernorm_plain(x, gamma * 1.01, beta, eps)


def xent_dx_high(x, labels, lse, dy):
    """A planted fault: the plain softmax-xent backward 1 % high."""
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    return sx.softmax_xent_bwd_plain(x, labels, lse, dy * 1.01)


# faults planted into the plain-version step: (the wrappers each one
# replaces, whether the step's gradient limit must catch it). A dq missing
# one K/V tile moves the gradients about as far as bf16 rounding does, and
# a 1 % scale of the loss gradient moves each by 1 %; only the kernel
# checks at the step's shapes catch those two
PLANTED_FAULTS = {
    "LayerNorm gamma 1% high": (
        {"fused_layernorm": layernorm_gamma_high}, True),
    "dk/dv drop the last query tile": (
        {"flash_attention_bwd": dkv_last_query_tile_dropped}, True),
    "dq drops the last K/V tile": (
        {"flash_attention_bwd": dq_last_tile_dropped}, False),
    "softmax-xent dx 1% high": ({"softmax_xent_bwd": xent_dx_high}, False),
    "none (the plain step again)": ({}, False),
}


def phase_train(dev):
    """The bert512 step: a few steps with finite losses that move the
    weights, exact launch counts a step, one step against the same step
    with the plain versions, and the step's wall and samples/s."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    t0 = time.perf_counter()
    step = TrainStep(dev, BERT512)
    n_params = sum(p._tensor().numel() for p in step.params)
    watch = [step.model.word_embed.weight, step.model.encoder.ln.gamma,
             step.model.encoder.cells[0].attention.qkv.weight]
    before = [p._tensor().detach().clone() for p in watch]
    torch.cuda.synchronize()
    print("bert512 step: %d parameters, batch %d, seq %d, %d masked; set-up "
          "%.2f s" % (n_params, BERT512["batch"], BERT512["seq"],
                      BERT512["masked"], time.perf_counter() - t0), flush=True)

    # (a), (b): the main path, with every counter at 0 just before it
    reset_counters()
    losses = [float(step().mean()) for _ in range(TRAIN_STEPS)]
    launches = read_counters()
    print("bert512 losses %s; kernel launches in %d steps: %s"
          % (["%.4f" % x for x in losses], TRAIN_STEPS, launches), flush=True)
    check(all(np.isfinite(losses)), "non-finite training loss")
    for p, b in zip(watch, before):
        check(not torch.equal(p._tensor(), b), "a weight did not move")
    for name, n in STEP_LAUNCHES.items():
        check(launches[name] == n * TRAIN_STEPS,
              "%s launches %d != %d x %d steps" % (name, launches[name], n,
                                                   TRAIN_STEPS))

    # (c): one step with the kernels and the same step with the plain
    # versions, from the same weights and the same dropout generator
    mx_random.seed(SEED)
    loss_k = step(update=False).float()
    grads_k = _grads(step.params)
    for p, gk in zip(step.params, grads_k):
        check(bool(torch.isfinite(gk).all()), "%s: non-finite grad" % p.name)
    mx_random.seed(SEED)
    reset_counters()
    with plain_versions():
        loss_p = step(update=False).float()
    check(not any(read_counters().values()),
          "the plain-version step launched a kernel: %s" % read_counters())
    grads_p = _grads(step.params)
    loss_err = float((loss_k.mean() - loss_p.mean()).abs())
    rel = grad_rel_l2(step.params, grads_k, grads_p)
    print("bert512 step with kernels vs plain versions: loss %.6f vs %.6f "
          "(|diff| %.3g, limit %g); worst gradient relative L2 %s (limit %g)"
          % (float(loss_k.mean()), float(loss_p.mean()), loss_err,
             STEP_LOSS_TOL, ["%.3g %s" % r for r in rel[:5]], STEP_GRAD_TOL),
          flush=True)
    check(loss_err <= STEP_LOSS_TOL, "step loss disagrees with plain versions")
    check(rel[0][0] <= STEP_GRAD_TOL, "gradient disagrees with plain "
          "versions: %s" % (rel[0],))
    # the same limit against planted faults: the plain step once more with
    # one wrapper replaced by a faulty version
    del grads_k
    faults = {}
    for name, (override, must_catch) in PLANTED_FAULTS.items():
        mx_random.seed(SEED)
        with plain_versions(**override):
            loss_f = step(update=False).float()
        faults[name] = {
            "loss_err": float((loss_f.mean() - loss_p.mean()).abs()),
            "worst_grad_rel_l2": [[r, n] for r, n in grad_rel_l2(
                step.params, _grads(step.params), grads_p)[:3]]}
        print("bert512 step, planted fault %r vs plain versions: loss |diff| "
              "%.3g, worst gradient relative L2 %s" % (
                  name, faults[name]["loss_err"],
                  ["%.3g %s" % tuple(r)
                   for r in faults[name]["worst_grad_rel_l2"]]), flush=True)
        check(not must_catch
              or faults[name]["worst_grad_rel_l2"][0][0] > STEP_GRAD_TOL,
              "the step's gradient limit misses the planted fault %r" % name)
    del grads_p

    # (d): the step's wall after warm-up
    step.timed(1)
    wall, timed_losses = step.timed(TIMED_STEPS)
    check(all(np.isfinite(timed_losses)), "non-finite training loss")
    result = {"recipe": BERT512, "losses": losses + timed_losses,
              "launches": launches, "steps_counted": TRAIN_STEPS,
              "loss_vs_plain": [float(loss_k.mean()), float(loss_p.mean())],
              "worst_grad_rel_l2": [[r, n] for r, n in rel[:5]],
              "planted_faults": faults,
              "step_wall_ms_median": wall,
              "samples_per_s": BERT512["batch"] / wall * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("bert512 step: median wall %.3f ms over %d steps, %.2f samples/s; "
          "peak memory %.2f GB" % (wall, TIMED_STEPS, result["samples_per_s"],
                                   result["peak_memory_gb"]), flush=True)
    return step, result


def _train_kernel_class(name):
    for key, cls in (("flash_fwd_kernel", "flash_attention_fwd"),
                     # the backward kernel and its dq pass
                     ("flash_bwd_", "flash_attention_bwd"),
                     ("xent_fwd_kernel", "softmax_xent_fwd"),
                     ("xent_bwd_kernel", "softmax_xent_bwd"),
                     ("layernorm_fwd_", "layernorm_fwd"),
                     # the backward kernel and its finishing kernel
                     ("layernorm_bwd_", "layernorm_bwd"),
                     ("multi_tensor_apply", "optimizer (foreach)")):
        if key in name:
            return cls
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    return "other"


def phase_train_breakdown(step, n_prof=2, label="bert512 step"):
    """Where a training step spends its time, from one torch.profiler
    window: kernel time by class, the host time of the LayerNorm backward
    and of the optimizer step (their profiler ranges), the optimizer
    range's device time, and the device idle share."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_prof
    by_class, ranges_host, ranges_device, top = {}, {}, {}, []
    dq_pass = 0.0
    for ev in prof.key_averages():
        if ev.key.startswith("mxnet_tpu_torch::"):
            # a profiler range: its host time, and, where its kernels come
            # from torch ops, their device time; its span on the device
            # timeline (a CUDA-side event of the same name, gaps included)
            # is not kernel time
            if ev.device_type != DeviceType.CUDA:
                ranges_host[ev.key] = ev.cpu_time_total / 1e3 / n_prof
                if ev.key in TORCH_OP_RANGES:
                    ranges_device[ev.key] = (ev.device_time_total / 1e3
                                             / n_prof)
        elif ev.device_type == DeviceType.CUDA:
            ms = ev.self_device_time_total / 1e3 / n_prof
            cls = _train_kernel_class(ev.key)
            by_class[cls] = by_class.get(cls, 0.0) + ms
            if "flash_bwd_dq_kernel" in ev.key:
                dq_pass += ms
            top.append((ms, ev.count // n_prof, ev.key[:90]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    out = {"kernel_ms_per_step": by_class,
           "range_host_ms_per_step": ranges_host,
           "range_device_ms_per_step": ranges_device,
           "profiled_wall_ms_per_step": wall,
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall,
           "flash_bwd_dq_pass_ms_per_step": dq_pass,
           "flash_bwd_dq_pass_share": dq_pass / max(
               by_class.get("flash_attention_bwd", 0.0), 1e-12)}
    print("flash backward a step: %.4f ms, of which the dq pass %.4f ms "
          "(%.1f%%)" % (by_class.get("flash_attention_bwd", 0.0), dq_pass,
                        100 * out["flash_bwd_dq_pass_share"]), flush=True)
    print("%s breakdown (torch.profiler, %d steps): kernel ms a "
          "step by class %s; host ms of the ranges %s, device ms %s; %.3f ms "
          "busy in %.3f ms of wall under the profiler: device idle %.1f%%"
          % (label, n_prof,
             {k: round(v, 4) for k, v in sorted(by_class.items())},
             {k: round(v, 4) for k, v in ranges_host.items()},
             {k: round(v, 4) for k, v in ranges_device.items()}, busy, wall,
             100 * out["device_idle_share"]), flush=True)
    for ms, n, name in top[:20]:
        print("  %8.4f ms  x%-4d %s" % (ms, n, name))
    check(busy > 0, "the profiler saw no kernel time")
    return out


def phase_bert128(dev):
    """The bert headline step (batch 64, seq 128, 20 masked): dense
    attention with its hand-written backward, the softmax-xent kernels;
    samples/s and launches a step."""
    import torch

    step = TrainStep(dev, BERT128)
    step.timed(2)
    reset_counters()
    wall, losses = step.timed(TIMED_STEPS)
    launches = read_counters()
    check(all(np.isfinite(losses)), "non-finite bert128 loss")
    want = dict(STEP_LAUNCHES, flash_attention_fwd=0, flash_attention_bwd=0)
    for name, n in want.items():
        check(launches[name] == n * TIMED_STEPS,
              "bert128 %s launches %d != %d x %d steps"
              % (name, launches[name], n, TIMED_STEPS))
    out = {"recipe": BERT128, "losses": losses, "launches": launches,
           "steps_counted": TIMED_STEPS, "step_wall_ms_median": wall,
           "samples_per_s": BERT128["batch"] / wall * 1e3}
    print("bert128 step: median wall %.3f ms over %d steps, %.2f samples/s; "
          "launches %s" % (wall, TIMED_STEPS, out["samples_per_s"], launches),
          flush=True)
    del step
    torch.cuda.empty_cache()
    return out


def _sdpa_mask(vl, T, dev):
    import torch

    return (torch.arange(T, device=dev)[None, :]
            < torch.as_tensor(vl, device=dev)[:, None])[:, None, None, :]


def kernel_record(name, source, replaces, launches, steps, err, ms, plain_ms,
                  lib_ms, t_ops, t_bytes, **extra):
    """One entry of the ``kernels`` line: ``launches`` is the count of the
    bert512 step's run of ``steps`` steps; the bound is the larger of the
    operations' and the bytes' least time (seconds)."""
    rec = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "launches": launches,
           "launches_per_step": launches / steps, "max_abs_err": err,
           "ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(t_ops, t_bytes) * 1e3,
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": lib_ms}
    rec.update(extra)
    return rec


def _ln_bound(R, C, esize):
    """(operations, bytes) least times of a LayerNorm of (R, C): x read and
    y written once, fp32 gamma and beta; about 8 fp32 operations an
    element."""
    return 8 * R * C / PEAK_FP32, (2 * R * C * esize + 2 * C * 4) / PEAK_BYTES


def _ln_bwd_bound(R, C, esize):
    """(operations, bytes) least times of a LayerNorm backward of (R, C):
    x and dy read and dx written once, fp32 gamma read and dgamma and dbeta
    written once; about 16 fp32 operations an element."""
    return 16 * R * C / PEAK_FP32, (3 * R * C * esize + 3 * C * 4) / PEAK_BYTES


def _flash_fwd_bound(B, H, T, D, vl, lse):
    """(operations, bytes) least times of the flash forward in bf16: every
    query row against its example's valid keys (two products), q and o
    whole, the valid rows of k and v, and the lse when it is written."""
    n_keys = int(np.sum(vl))
    ops = 4 * H * T * D * n_keys
    nbytes = 2 * (2 * B * H * T * D + 2 * H * D * n_keys) + 4 * B
    if lse:
        nbytes += 4 * B * H * T
    return ops / PEAK_BF16, nbytes / PEAK_BYTES


def _flash_bwd_bound(B, H, T, D, vl):
    """(operations, bytes) least times of the flash backward in bf16: the
    five products over every query row and its example's valid keys
    (10 * pairs), q, k, v, dO and dq, dk, dv once each, lse and delta."""
    pairs = H * T * D * int(np.sum(vl))
    nbytes = 7 * B * H * T * D * 2 + 2 * B * H * T * 4 + 4 * B
    return 10 * pairs / PEAK_BF16, nbytes / PEAK_BYTES


def phase_timing(dev, launches, steps, errs, serve_launches, forwards,
                 serve_vl):
    """Records of the two forward kernels at the bert512 step's shapes, with
    the same numbers at a served bucket-8 forward's shapes beside them
    (``serving``), and dense against flash attention."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.attention import dense_attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    records = []

    # LayerNorm: the step's (16 * 512, 768) and a served bucket-8 forward's
    # (8 * 512, 768), bf16 with fp32 gamma and beta
    C = 768
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    shapes = [(BERT512["batch"] * BERT512["seq"], C), (BUCKETS[-1] * SEQ, C)]
    fns = []
    for R, _ in shapes:
        x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
        fns += [lambda x=x: fused_layernorm(x, gamma, beta, 1e-12),
                lambda x=x: layernorm_plain(x, gamma, beta, 1e-12),
                lambda x=x: TF.layer_norm(x, (C,), gb, bb, 1e-12)]
    t = time_ms(*fns)
    serving = dict(zip(("ms", "plain_ms", "library_ms"), t[3:]),
                   shape=list(shapes[1]),
                   bound_ms=max(_ln_bound(*shapes[1], 2)) * 1e3,
                   launches=serve_launches["layernorm"],
                   launches_per_forward=serve_launches["layernorm"] / forwards)
    records.append(kernel_record(
        "layernorm_fwd", "mxnet_tpu_torch/csrc/layernorm.cu",
        "mxnet_tpu/ops/pallas/layernorm.py:67", launches["layernorm"], steps,
        errs["layernorm"], *t[:3], *_ln_bound(*shapes[0], 2),
        shape=list(shapes[0]), dtype="bfloat16", serving=serving))

    # flash forward: the step's (16, 12, 512, 64), every key valid, with the
    # lse; a served bucket-8 forward's, with the valid lengths of the first
    # full batch the server dispatched and no lse; head dim 128 at
    # (16, 6, 512, 128), every key valid, with the lse. Where every key is
    # valid SDPA is also timed without a mask (the card's own flash
    # backend, the stronger yardstick)
    H, D = 12, 64
    step_shape = (BERT512["batch"], H, BERT512["seq"], D)
    d128_shape = (BERT512["batch"], 6, BERT512["seq"], 128)
    step_vl = np.full(step_shape[0], step_shape[2])
    B = BUCKETS[-1]
    vl = np.asarray(serve_vl[:B], np.int64)
    groups = []
    for shape, lens, lse in ((step_shape, step_vl, True),
                             ((B, H, SEQ, D), vl, False),
                             (d128_shape, step_vl, True)):
        q, k, v = _qkv(dev, g, *shape)
        vlt = torch.tensor(lens, dtype=torch.int32, device=dev)
        mask = _sdpa_mask(lens, shape[2], dev)
        group = [lambda q=q, k=k, v=v, vlt=vlt, lse=lse: flash_attention(
                     q, k, v, kv_valid_len=vlt, return_lse=lse),
                 lambda q=q, k=k, v=v, vlt=vlt, lse=lse: flash_attention_plain(
                     q, k, v, kv_valid_len=vlt, return_lse=lse),
                 lambda q=q, k=k, v=v, mask=mask:
                     TF.scaled_dot_product_attention(q, k, v, attn_mask=mask)]
        if (lens == shape[2]).all():
            group.append(lambda q=q, k=k, v=v:
                         TF.scaled_dot_product_attention(q, k, v))
        groups.append(group)
    t = iter(time_ms(*[fn for group in groups for fn in group]))
    step_t, serve_t, d128_t = ([next(t) for _ in group] for group in groups)
    serving = dict(zip(("ms", "plain_ms", "library_ms"), serve_t),
                   shape=[B, H, SEQ, D], valid_len=vl.tolist(),
                   bound_ms=max(_flash_fwd_bound(B, H, SEQ, D, vl, False))
                   * 1e3,
                   launches=serve_launches["flash_attention_fwd"],
                   launches_per_forward=serve_launches["flash_attention_fwd"]
                   / forwards)
    d128 = dict(zip(("ms", "plain_ms", "library_ms", "library_unmasked_ms"),
                    d128_t), shape=list(d128_shape),
                bound_ms=max(_flash_fwd_bound(*d128_shape, step_vl, True))
                * 1e3)
    records.append(kernel_record(
        "flash_attention_fwd", "mxnet_tpu_torch/csrc/flash_attention_fwd.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:147",
        launches["flash_attention_fwd"], steps, errs["flash_attention_fwd"],
        *step_t[:3], *_flash_fwd_bound(*step_shape, step_vl, True),
        shape=list(step_shape), dtype="bfloat16", return_lse=True,
        library="scaled_dot_product_attention with the bool mask",
        library_unmasked_ms=step_t[3], serving=serving, head_dim_128=d128))
    for r in records:
        print("time %-20s kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s) at %s; serving %s: %.4f / %.4f / %.4f ms"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"], r["shape"],
                 r["serving"]["shape"], r["serving"]["ms"],
                 r["serving"]["plain_ms"], r["serving"]["library_ms"]),
              flush=True)
    print("time flash_attention_fwd: SDPA without a mask %.4f ms at %s; at %s "
          "kernel %.4f ms, plain %.4f ms, SDPA %.4f ms (without a mask %.4f "
          "ms), bound %.4f ms" % (step_t[3], list(step_shape), d128["shape"],
                                  d128["ms"], d128["plain_ms"],
                                  d128["library_ms"],
                                  d128["library_unmasked_ms"],
                                  d128["bound_ms"]), flush=True)

    # dense against flash at seq 128 and 512 (B 8, H 12, D 64, bf16), all
    # keys valid and with the serving valid lengths scaled to the length
    crossover = []
    for T in (128, 512):
        q, k, v = _qkv(dev, g, B, H, T, D)
        for label, lens in (("full", np.full(B, T)),
                            ("serve", np.maximum(1, vl * T // SEQ))):
            lt = torch.tensor(lens, dtype=torch.int32, device=dev)
            mask = _sdpa_mask(lens, T, dev).to(torch.float32)
            dense, flash = time_ms(
                lambda: dense_attention(q, k, v, mask),
                lambda: flash_attention(q, k, v, kv_valid_len=lt))
            crossover.append({"seq": T, "valid_len": label,
                              "dense_ms": dense, "flash_ms": flash})
            print("attention seq %d (%s lengths): dense %.4f ms, flash %.4f ms"
                  % (T, label, dense, flash), flush=True)
    return records, crossover


def phase_train_timing(dev, launches, errs, steps):
    """Records of the four training kernels at the bert512 step's shapes:
    CUDA-graph replay of the kernel, its plain version and a PyTorch
    library call computing the same function, and the bound. A library
    backward is timed as forward + backward less the forward alone."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    records = []

    def record(name, source, replaces, *times, **extra):
        records.append(kernel_record(name, source, replaces, launches[name],
                                     steps, errs[name], *times, **extra))

    # the LayerNorm backward at the step's (16 * 512, 768), eps 1e-12, and
    # at the MLM head's (16 * 80, 768); its library call is aten's
    # backward with bf16 gamma and beta, given the forward's saved mean and
    # rstd (the kernel recomputes them)
    C = 768
    ln_t = []
    for R in (BERT512["batch"] * BERT512["seq"],
              BERT512["batch"] * BERT512["masked"]):
        x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
        dy = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
        gamma = torch.randn(C, device=dev, generator=g)
        gb = gamma.to(torch.bfloat16)
        bb = torch.zeros_like(gb)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], gb, bb, 1e-12)
        ln_t.append((R, time_ms(
            lambda x=x, dy=dy, gamma=gamma: ln.fused_layernorm_bwd(
                x, gamma, dy, 1e-12),
            lambda x=x, dy=dy, gamma=gamma: ln.layernorm_bwd_plain(
                x, gamma, dy, 1e-12),
            lambda x=x, dy=dy, gb=gb, bb=bb, mean=mean, rstd=rstd:
                torch.ops.aten.native_layer_norm_backward(
                    dy, x, [C], mean, rstd, gb, bb, [True, True, True]))))
        del x, dy, mean, rstd
    head = dict(zip(("ms", "plain_ms", "library_ms"), ln_t[1][1]),
                shape=[ln_t[1][0], C],
                bound_ms=max(_ln_bwd_bound(ln_t[1][0], C, 2)) * 1e3)
    record("layernorm_bwd", "mxnet_tpu_torch/csrc/layernorm_bwd.cu",
           "mxnet_tpu/ops/pallas/layernorm.py:40", *ln_t[0][1],
           *_ln_bwd_bound(ln_t[0][0], C, 2), shape=[ln_t[0][0], C],
           dtype="bfloat16", replaces_note="_ln_bwd, the custom_vjp's "
           "backward: XLA in the JAX package, no pallas_call",
           library="aten native_layer_norm_backward, bf16 gamma, the "
           "forward's mean and rstd given", mlm_head=head)
    print("time layernorm_bwd at %s: kernel %.4f ms, plain %.4f ms, library "
          "%.4f ms, bound %.5f ms" % (head["shape"], head["ms"],
                                      head["plain_ms"], head["library_ms"],
                                      head["bound_ms"]), flush=True)

    # softmax-xent at the MLM head: (16 * 80, 30522) bf16 logits
    R, V = BERT512["batch"] * BERT512["masked"], VOCAB
    x = (torch.randn(R, V, device=dev, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    dy = torch.full((R,), 1.0 / BERT512["batch"], device=dev)
    _, lse = sx.softmax_xent_fwd_plain(x, labels)
    xf = x.float().requires_grad_()
    lab64 = labels.long()

    def lib_fwd():
        return TF.cross_entropy(xf, lab64, reduction="none")

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), xf, dy)

    ms, plain_ms, lib_ms, lib_both = time_ms(
        lambda: sx.softmax_xent_fwd(x, labels),
        lambda: sx.softmax_xent_fwd_plain(x, labels),
        lib_fwd, lib_fwd_bwd)
    ops = 5 * R * V  # max, subtract, exp, add, label compare, fp32
    xbytes = R * V * x.element_size()
    record("softmax_xent_fwd", "mxnet_tpu_torch/csrc/softmax_xent.cu",
           "mxnet_tpu/ops/pallas/softmax_xent.py:75", ms, plain_ms, lib_ms,
           ops / PEAK_FP32, (xbytes + 3 * R * 4) / PEAK_BYTES,
           shape=[R, V], dtype="bfloat16",
           library="F.cross_entropy(reduction='none') on fp32 logits")
    ms, plain_ms = time_ms(
        lambda: sx.softmax_xent_bwd(x, labels, lse, dy),
        lambda: sx.softmax_xent_bwd_plain(x, labels, lse, dy))
    record("softmax_xent_bwd", "mxnet_tpu_torch/csrc/softmax_xent.cu",
           "mxnet_tpu/ops/pallas/softmax_xent.py:94", ms, plain_ms,
           lib_both - lib_ms, ops / PEAK_FP32,
           (2 * xbytes + 3 * R * 4) / PEAK_BYTES, shape=[R, V],
           dtype="bfloat16",
           library="backward of F.cross_entropy on fp32 logits (forward + "
           "backward less forward)")
    del x, xf, lse

    # the flash backward at (16, 12, 512, 64), every key valid, and the
    # same at head dim 128 (16, 6, 512, 128)
    lib = "backward of scaled_dot_product_attention with the bool mask " \
        "(forward + backward less forward)"
    at_d128 = None
    for H, D in ((12, 64), (6, 128)):
        B, T = BERT512["batch"], BERT512["seq"]
        vl = torch.full((B,), T, dtype=torch.int32, device=dev)
        q, k, v, do, lse, delta = flash_bwd_inputs(dev, g, B, H, T, D, vl)
        args = (q, k, v, do, lse, delta)
        qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
        mask = _sdpa_mask(np.full(B, T), T, dev)

        def sdpa():
            return TF.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)

        def sdpa_fwd_bwd():
            return torch.autograd.grad(sdpa(), (qs, ks, vs), do)

        ms, plain_ms, lib_fwd_ms, lib_both = time_ms(
            lambda: fa.flash_attention_bwd(*args, kv_valid_len=vl),
            lambda: fa.flash_attention_bwd_plain(*args, kv_valid_len=vl),
            sdpa, sdpa_fwd_bwd)
        t_ops, t_bytes = _flash_bwd_bound(B, H, T, D, vl.cpu().numpy())
        if D == 64:
            record("flash_attention_bwd",
                   "mxnet_tpu_torch/csrc/flash_attention_bwd.cu",
                   "mxnet_tpu/ops/pallas/flash_attention.py:288 and :311",
                   ms, plain_ms, lib_both - lib_fwd_ms, t_ops, t_bytes,
                   shape=[B, H, T, D], dtype="bfloat16", library=lib)
        else:
            at_d128 = {"shape": [B, H, T, D], "ms": ms, "plain_ms": plain_ms,
                       "library_ms": lib_both - lib_fwd_ms,
                       "bound_ms": max(t_ops, t_bytes) * 1e3}
        del q, k, v, do, lse, delta, args, qs, ks, vs
    records[-1]["head_dim_128"] = at_d128
    print("time flash_attention_bwd at %s: kernel %.4f ms, plain %.4f ms, "
          "library %.4f ms, bound %.4f ms" % (
              at_d128["shape"], at_d128["ms"], at_d128["plain_ms"],
              at_d128["library_ms"], at_d128["bound_ms"]), flush=True)
    for r in records:
        print("time %-20s kernel %.4f ms, plain %.4f ms, library %.4f ms, "
              "bound %.4f ms (%s), %g launches a step"
              % (r["name"], r["ms"], r["plain_ms"], r["library_ms"],
                 r["bound_ms"], r["bound_by"], r["launches_per_step"]),
              flush=True)
    return records


def phase_train_crossover(dev):
    """Dense against flash attention, forward plus backward, at seq 64, 128,
    256 and 512 with 8192 tokens (the bert and bert512 steps' batches at 128
    and 512), every key valid, (H 12, D 64, bf16): the training side of the
    seam's length gate."""
    import torch
    from mxnet_tpu_torch.ops.attention import dense_attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_with_grad)

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    H, D = 12, 64
    out = []
    for T in (64, 128, 256, 512):
        B = 8192 // T
        q, k, v, do = [torch.randn(B, H, T, D, device=dev, generator=g)
                       .to(torch.bfloat16) for _ in range(4)]
        leaves = [t.requires_grad_() for t in (q, k, v)]
        mask = _sdpa_mask(np.full(B, T), T, dev).to(torch.float32)
        lt = torch.full((B,), T, dtype=torch.int32, device=dev)

        def dense():
            return torch.autograd.grad(dense_attention(*leaves, mask), leaves,
                                       do)

        def flash():
            return torch.autograd.grad(
                flash_attention_with_grad(*leaves, kv_valid_len=lt), leaves,
                do)

        dense_ms, flash_ms = time_ms(dense, flash)
        out.append({"seq": T, "batch": B, "dense_ms": dense_ms,
                    "flash_ms": flash_ms})
        print("attention forward + backward, seq %d batch %d: dense %.4f ms, "
              "flash %.4f ms" % (T, B, dense_ms, flash_ms), flush=True)
    return out


# ----------------------------------------------------------- GPT serving
# GPT-2 small at its published widths (``mxnet_tpu/models/gpt.py:464``
# ``gpt2_small``), random weights from a seed, bf16 via amp
GPT_CONFIG = {"vocab_size": GPT_VOCAB, "units": 768, "num_layers": 12,
              "num_heads": 12, "max_length": 1024}
GPT_SLOTS = 8
GPT_TOP_K = 40
GPT_NEW_TOKENS = 64
# per burst: (prompt length, temperature, seed); lengths over 256 prefill at
# buckets 512 and 1024 (flash), 128 or less densely; None repeats an
# earlier prompt (a prefix-cache hit)
GPT_BURSTS = (
    [(300, 0, 0), (16, 0, 0), (450, 0.8, 11), (48, 0, 0), (600, 0, 0),
     (100, 0.8, 12), (900, 0, 0), (128, 0, 0), (200, 0, 0), (20, 0.8, 13),
     (64, 0, 0), ("repeat", 1)],
    [(20, 0.8, 13), (700, 0, 0), (32, 0, 0), (350, 0, 0), (100, 0.8, 12),
     (80, 0, 0), (512, 0, 0), (8, 0, 0), ("repeat", 0), (450, 0.8, 11),
     (120, 0, 0), (260, 0, 0)],
)
# a greedy stream may part from its batch-1 reference only at a step where
# the reference's logit of its own token leads its logit of the served
# token by less than this (twice the largest gap met at a parting on the
# card, 0.031): the served step runs 8 slots (other GEMM tiles) over a
# 1024-key cache, the reference one row over its own, both in bf16
# through 12 layers. Where a stream parts, it is driven again alone and
# the logits of every step up to the parting are held elementwise to the
# reference's under GEN_TOL
GREEDY_TIE_TOL = 0.0625
# the prefill with the kernels against the same prefill with the plain
# versions, elementwise: |kernel - plain| <= atol + rtol |plain| + mtol
# rms, rms that of the plain tensor's row (its head's 64 values, or the
# logits). Layer 0's K/V come from the first LayerNorm alone: a rounding
# of its output that falls the other way moves a K or V by less than
# 2e-3 before it is rounded to bf16, so the two differ by one bf16 step at
# most (<= 2**-7 |plain|); a 1% gamma moves them by 1% (two to three
# steps). Later layers and the logits also carry the flash kernel's
# rounding of p through the layers, a few bf16 steps after 12 layers; a
# flash without its causal mask moves them by several times their rms
GEN_TOL_L0 = (2e-3, 2.0 ** -7, 0.0)
GEN_TOL = (1e-3, 2.0 ** -5, 2.0 ** -3)
GEN_PREFILL_LENS = (200, 300, 900)  # buckets 256, 512 and 1024


def _gpt_requests(vocab):
    """The two bursts: [(prompt int32, temperature, seed)] each. A sampled
    request of burst 2 repeats one of burst 1 (same prompt, seed and
    temperature) among other companions."""
    rng = np.random.RandomState(SEED)
    sampled, bursts = {}, []
    for spec in GPT_BURSTS:
        burst = []
        for item in spec:
            if item[0] == "repeat":
                burst.append(bursts[0][item[1]] if bursts else burst[item[1]])
                continue
            n, temp, seed = item
            if temp and (n, seed) in sampled:
                burst.append(sampled[(n, seed)])
                continue
            req = (rng.randint(0, vocab, n).astype(np.int32), temp, seed)
            if temp:
                sampled[(n, seed)] = req
            burst.append(req)
        bursts.append(burst)
    return bursts


def _gpt_model(dev, seed):
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.gpt import GPTModel

    model = GPTModel(dropout=0.1, **GPT_CONFIG)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    amp.convert_hybrid_block(model, "bfloat16")
    return model


def greedy_reference(model, prompt, n, dev):
    """``GPTModel.generate(use_cache=True)`` at batch 1, step by step as it
    runs (prefill, then ``step``), with the logits each generated token was
    chosen from: (tokens, logits (n, V) fp32 on the device)."""
    import torch
    from mxnet_tpu_torch.base import next_pow2

    T0 = len(prompt)
    x = torch.from_numpy(np.asarray(prompt, np.int64)[None]).to(dev)
    caches = model.init_cache(
        1, capacity=min(GPT_CONFIG["max_length"], next_pow2(T0 + n)))
    logits, caches = model.prefill(x, caches)
    toks, rows = [], []
    for i in range(n):
        rows.append(logits.float())
        nxt = torch.argmax(logits, dim=-1).reshape(1, 1)
        toks.append(nxt)
        if i + 1 < n:
            logits, caches = model.step(nxt, caches, T0 + i)
    return (torch.cat(toks).reshape(-1).cpu().numpy().tolist(),
            torch.cat(rows))


def top2_gaps(logits):
    """The top-1 minus top-2 logit of each row, on the host."""
    import torch

    top2 = torch.topk(torch.as_tensor(logits).float(), 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def compare_greedy(got, ref, logits, what):
    """(tokens compared, the margin where the streams parted or None): equal
    up to a step where the reference's logit of its token leads its logit
    of the served token by less than GREEDY_TIE_TOL, after which the stream
    is not compared. ``logits`` (n, V) are the reference's."""
    for i, (a, b) in enumerate(zip(got, ref)):
        if a != b:
            margin = float(logits[i][b] - logits[i][a])
            check(margin < GREEDY_TIE_TOL,
                  "%s: token %d is %d, the batch-1 reference's %d (margin "
                  "%.4f >= %g)" % (what, i, a, b, margin, GREEDY_TIE_TOL))
            return i + 1, margin
    check(len(got) == len(ref), "%s: %d tokens, reference %d"
          % (what, len(got), len(ref)))
    return len(got), None


def served_logits(srv, prompt, n):
    """A greedy request of ``n`` tokens served alone, with the logits each
    token was sampled from: (tokens, logits (n, V) fp32). A slot's row
    depends on no other slot, so the tokens are those the request got
    among companions. The prefill's row is read where its first token is
    sampled, each decode step's live row from the step's output (a
    replayed graph's output buffer, read before the next step)."""
    import torch

    rows = []
    sample_one, run_step = srv._sample_one, srv._run_step

    def first(last, *args):
        rows.append(last[None].float().clone())
        return sample_one(last, *args)

    def step(*args, **kwargs):
        logits = run_step(*args, **kwargs)
        rows.append(logits[srv._dev_active].float().clone())
        return logits

    srv._sample_one, srv._run_step = first, step
    try:
        with srv:
            toks = srv.generate(prompt, max_new_tokens=n)
    finally:
        del srv._sample_one, srv._run_step
    return toks, torch.cat(rows)


def check_served_logits(srv, prompt, stream, ref_logits, n, what):
    """Drive a greedy request again alone for its first ``n`` tokens: the
    tokens must be ``stream``'s, and each step's logits within GEN_TOL of
    the reference's. Returns (worst error/limit, max abs error)."""
    toks, logits = served_logits(srv, prompt, n)
    check(toks == list(stream[:n]), "%s: served alone, the first %d tokens "
          "differ from those served among companions" % (what, n))
    ratio = rms_ratio(logits, ref_logits[:n], GEN_TOL)
    check(ratio <= 1.0, "%s: the served step's logits disagree with the "
          "batch-1 reference's (error/limit %.3f)" % (what, ratio))
    return ratio, max_err(logits, ref_logits[:n])


def prefill_state(model, prompt, tp, dev):
    """One prefill at bucket ``tp``: the last prompt position's logits
    (fp32) and every layer's K and V over the prompt's positions."""
    import torch
    from mxnet_tpu_torch.ops import functional as F

    x = np.zeros((1, tp), np.int64)
    x[0, :len(prompt)] = prompt
    with torch.no_grad():
        logits, kvs = model.forward_collect_kv(
            F, torch.from_numpy(x).to(dev))
    n = len(prompt)
    return (logits[0, n - 1].float(),
            [(k[0, :, :n].float(), v[0, :, :n].float()) for k, v in kvs])


def rms_ratio(a, b, tol):
    """Worst |a - b| / (atol + rtol |b| + mtol rms), rms that of b's row
    (its last axis)."""
    import torch

    atol, rtol, mtol = tol
    rms = torch.sqrt((b * b).mean(dim=-1, keepdim=True))
    return float(((a - b).abs() / (atol + rtol * b.abs() + mtol * rms)).max())


def gen_worst_ratio(got, ref):
    """Worst error/limit of a prefill state against another (GEN_TOL_L0 on
    layer 0's K/V, GEN_TOL on the rest), and where it is."""
    worst = [(rms_ratio(got[0], ref[0], GEN_TOL), "logits")]
    for i, ((k, v), (rk, rv)) in enumerate(zip(got[1], ref[1])):
        tol = GEN_TOL_L0 if i == 0 else GEN_TOL
        worst += [(rms_ratio(k, rk, tol), "layer %d K" % i),
                  (rms_ratio(v, rv, tol), "layer %d V" % i)]
    return max(worst)


def flash_causal_dropped(q, k, v, **kw):
    """A planted fault: the plain flash attention without its causal
    mask."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_attention_plain(q, k, v, **dict(kw, causal=False))


GEN_FAULTS = {"flash without the causal mask": {
                  "flash_attention": flash_causal_dropped},
              "LayerNorm gamma 1% high": {
                  "fused_layernorm": layernorm_gamma_high}}


def warm_prompts(bursts):
    """The longest prompt length of each pow2 bucket the bursts use: the
    prompt lengths a server's warmup prefills."""
    from mxnet_tpu_torch.base import next_pow2

    longest = {}
    for burst in bursts:
        for p, _, _ in burst:
            b = next_pow2(len(p))
            longest[b] = max(longest.get(b, 0), len(p))
    return [longest[b] for b in sorted(longest)]


def serve_bursts(srv, bursts, new_tokens, what):
    """Each burst's requests submitted at once to the running server and
    drained by one reader thread each: (the streams' tokens per burst,
    per burst its wall, tokens/s and time to first token of the short (128
    tokens or fewer) and long prompts)."""
    streams, timing = [], []
    with srv:
        for burst in bursts:
            arrivals = [[] for _ in burst]
            t_burst = time.perf_counter()
            got = [srv.submit(p, max_new_tokens=new_tokens,
                              temperature=temp, seed=seed)
                   for p, temp, seed in burst]

            def drain(stream, out):
                for _ in stream:
                    out.append(time.perf_counter())

            readers = [threading.Thread(target=drain, args=(s, a))
                       for s, a in zip(got, arrivals)]
            for r in readers:
                r.start()
            for r in readers:
                r.join(timeout=600)
            wall = time.perf_counter() - t_burst
            check(all(s.done() for s in got), "a stream did not finish")
            streams.append([s.result(1) for s in got])
            ttft = {"short": [], "long": []}
            for (p, _, _), a in zip(burst, arrivals):
                cls = "short" if len(p) <= 128 else "long"
                ttft[cls].append((a[0] - t_burst) * 1e3)
            n_tok = sum(len(s) for s in streams[-1])
            timing.append({
                "wall_s": wall, "tokens": n_tok, "tokens_per_s": n_tok / wall,
                **{"ttft_%s_p%d_ms" % (c, q): float(np.percentile(v, q))
                   for c, v in ttft.items() if v for q in (50, 99)}})
            print("%s burst %d: %d requests, %d tokens in %.3f s, %.1f "
                  "tokens/s; time to first token %s" % (
                      what, len(timing), len(burst), n_tok, wall,
                      timing[-1]["tokens_per_s"],
                      {k: round(v, 2) for k, v in timing[-1].items()
                       if k.startswith("ttft")}), flush=True)
    return streams, timing


def phase_generate(dev):
    """GPT-2 small served through GenerativeServer in two bursts (see the
    module docstring): (a) greedy streams against batch-1 ``generate``,
    (b) prefix hits against their misses, (c) sampled streams across
    bursts, (d) a prefill at buckets 256, 512 and 1024 with the kernels
    against the plain versions, planted faults above the limit, (f) a
    weight swap. Returns (server, model, result); the launch counts are
    checked apart (:func:`check_generate_launches`)."""
    import tempfile

    import torch
    from mxnet_tpu_torch.base import next_pow2
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.serve import GenerativeServer

    t0 = time.perf_counter()
    model = _gpt_model(dev, SEED)
    n_params = sum(p._tensor().numel()
                   for p in model.collect_params().values())
    srv = GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                           prefix_cache=True, timeout_ms=600000.0,
                           device=dev)
    buckets = warm_prompts(_gpt_requests(GPT_CONFIG["vocab_size"]))
    srv.warmup(prompt_buckets=buckets, max_tokens=GPT_CONFIG["max_length"])
    torch.cuda.synchronize()
    print("gpt2_small: %d parameters, bf16 (norms fp32); GenerativeServer "
          "slots %d, top_k %d, capacity %d; set-up and warmup (prompts "
          "of %s tokens) %.2f s" % (n_params, GPT_SLOTS, GPT_TOP_K,
                                  srv.cache.capacity, buckets,
                                  time.perf_counter() - t0), flush=True)
    torch.cuda.reset_peak_memory_stats()
    bursts = _gpt_requests(GPT_CONFIG["vocab_size"])
    m0 = srv.stats()
    # the main path, every counter at 0 just before it
    reset_counters()
    streams, timing = serve_bursts(srv, bursts, GPT_NEW_TOKENS, "gpt")
    torch.cuda.synchronize()
    launches = read_counters()
    stats = srv.stats()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    prefills = stats["prefills"] - m0["prefills"]
    steps = stats["decode_steps"] - m0["decode_steps"]
    hits = stats["prefix_hits"] - m0["prefix_hits"]
    graphs = {"captures": stats["step_captures"] - m0["step_captures"],
              "replays": stats["step_replays"] - m0["step_replays"],
              "programs": stats["step_programs"]}
    print("gpt decode step programs: %s over %d decode steps"
          % (graphs, steps), flush=True)
    check(graphs["captures"] == 0 and graphs["replays"] == steps,
          "gpt serving: %d captures and %d replays over %d decode steps "
          "(warmup captures; one replay a step)"
          % (graphs["captures"], graphs["replays"], steps))
    # the misses: first sightings of each prompt, each a prefill at its
    # pow2 bucket; flash runs at buckets of 256 and more
    seen, flash_prefills = set(), 0
    for burst in bursts:
        for p, _, _ in burst:
            if p.tobytes() not in seen:
                seen.add(p.tobytes())
                flash_prefills += next_pow2(len(p)) >= 256
    print("gpt serving: %d prefills (%d at buckets >= 256), %d prefix hits, "
          "%d decode steps; kernel launches %s; step host wall p50 %s p99 %s "
          "ms; peak memory %.2f GB" % (
              prefills, flash_prefills, hits, steps, launches,
              stats["itl_p50_ms"], stats["itl_p99_ms"], peak_gb), flush=True)
    check(stats["errors"] == 0 and stats["timeouts"] == 0,
          "generative serving errors: %s" % stats)
    check(prefills == len(seen) and hits == sum(map(len, bursts)) - len(seen),
          "prefills %d / hits %d, expected %d / %d" % (
              prefills, hits, len(seen), sum(map(len, bursts)) - len(seen)))
    for burst, outs in zip(bursts, streams):
        for (p, _, _), s in zip(burst, outs):
            check(len(s) == GPT_NEW_TOKENS
                  and all(0 <= t < GPT_CONFIG["vocab_size"] for t in s),
                  "a stream of %d tokens or a token out of range" % len(s))

    # (b) a prefix hit gives its miss's stream, (c) a sampled request its
    # stream of the other burst
    by_prompt = {}
    for burst, outs in zip(bursts, streams):
        for (p, temp, seed), s in zip(burst, outs):
            by_prompt.setdefault((p.tobytes(), temp, seed), []).append(s)
    repeats = [v for v in by_prompt.values() if len(v) > 1]
    check(len(repeats) == 5, "expected 5 repeated requests, %d" % len(repeats))
    for v in repeats:
        check(all(s == v[0] for s in v[1:]),
              "a repeated request's stream differs: %s" % v)
    # (a) greedy streams against batch-1 generate
    t0 = time.perf_counter()
    compared, parted, gaps = 0, [], []
    refs, recheck = {}, {}
    for burst, outs in zip(bursts, streams):
        for (p, temp, seed), s in zip(burst, outs):
            if temp:
                continue
            if p.tobytes() not in refs:
                refs[p.tobytes()] = greedy_reference(model, p,
                                                     GPT_NEW_TOKENS, dev)
            ref, ref_logits = refs[p.tobytes()]
            n, margin = compare_greedy(s, ref, ref_logits,
                                       "greedy stream (prompt %d)" % len(p))
            compared += n
            gaps.extend(top2_gaps(ref_logits[:n]).tolist())
            if margin is not None:
                parted.append(margin)
                recheck[p.tobytes()] = (p, s, n)
    p0, _, _ = bursts[0][0]
    check(model.generate(p0[None], GPT_NEW_TOKENS, device=dev)[0, len(p0):]
          .tolist() == refs[p0.tobytes()][0],
          "the step-by-step reference differs from GPTModel.generate")
    # every stream that parted, and the first greedy stream in any case,
    # driven again alone: its logits up to the parting against the
    # reference's, elementwise
    recheck.setdefault(p0.tobytes(), (p0, streams[0][0], GPT_NEW_TOKENS))
    served = [check_served_logits(srv, p, s, refs[p.tobytes()][1], n,
                                  "greedy stream (prompt %d)" % len(p))
              for p, s, n in recheck.values()]
    logits_check = {"streams": len(served),
                    "steps": sum(n for _, _, n in recheck.values()),
                    "worst_ratio": max(r for r, _ in served),
                    "max_abs_err": max(e for _, e in served)}
    print("gpt greedy streams vs batch-1 generate: %d tokens compared over "
          "%d streams, %d parted (margin < %g; largest %s; median top-1/"
          "top-2 gap of the compared steps %.4f); served logits vs the "
          "reference's over %d steps of %d streams: max abs err %.4g, worst "
          "error/limit %.3f; %.2f s" % (
              compared, sum(1 for b in bursts for _, t, _ in b if not t),
              len(parted), GREEDY_TIE_TOL,
              "%.4f" % max(parted) if parted else "none",
              float(np.median(gaps)), logits_check["steps"],
              logits_check["streams"], logits_check["max_abs_err"],
              logits_check["worst_ratio"], time.perf_counter() - t0),
          flush=True)

    # (d) a prefill at buckets 256, 512 and 1024 with the kernels against
    # the plain versions, and planted faults against the limit
    rng = np.random.RandomState(SEED + 7)
    prefills_vs_plain = []
    for length in GEN_PREFILL_LENS:
        prompt = rng.randint(0, GPT_CONFIG["vocab_size"],
                             length).astype(np.int32)
        tp = next_pow2(length)
        got = prefill_state(model, prompt, tp, dev)
        reset_counters()
        with plain_versions():
            ref = prefill_state(model, prompt, tp, dev)
        check(not any(read_counters().values()),
              "the plain prefill launched a kernel: %s" % read_counters())
        check(bool(torch.isfinite(got[0]).all()), "non-finite prefill logits")
        prefill = {"prompt": length, "bucket": tp,
                   "max_abs_err_logits": max_err(got[0], ref[0]),
                   "max_abs_err_kv": max(max_err(a, b) for x, y in
                                         zip(got[1], ref[1])
                                         for a, b in zip(x, y)),
                   "worst": gen_worst_ratio(got, ref), "faults": {}}
        for name, override in GEN_FAULTS.items():
            with plain_versions(**override):
                bad = prefill_state(model, prompt, tp, dev)
            prefill["faults"][name] = gen_worst_ratio(bad, ref)
        print("gpt prefill (%d tokens, bucket %d) with kernels vs plain "
              "versions: max abs err logits %.4g, K/V %.4g; worst "
              "error/limit %.3f at %s; planted faults %s" % (
                  length, tp, prefill["max_abs_err_logits"],
                  prefill["max_abs_err_kv"], *prefill["worst"],
                  {k: "%.3f at %s" % v for k, v in prefill["faults"].items()}),
              flush=True)
        check(prefill["worst"][0] <= 1.0, "the prefill at bucket %d with the "
              "kernels disagrees with the plain versions" % tp)
        for name, (r, _) in prefill["faults"].items():
            check(r > 1.0, "the prefill limit at bucket %d misses the planted "
                  "fault %r" % (tp, name))
        prefills_vs_plain.append(prefill)

    # (f) a weight swap: a second model's parameters through a file
    model2 = _gpt_model(dev, SEED + 1)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    path = os.path.join(tmp, "gpt2_seed1.params")
    try:
        model2.save_parameters(path)
        epoch = srv.swap_parameters(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(tmp)
    check(len(srv.prefix) == 0, "the swap left the prefix cache filled")
    p = bursts[0][1][0]  # a prompt the prefix cache held
    misses = srv.prefix.misses
    with srv:
        swapped = srv.generate(p, max_new_tokens=GPT_NEW_TOKENS)
    check(srv.prefix.misses == misses + 1, "a swapped server hit a stale "
          "prefix entry")
    ref2, logits2 = greedy_reference(model2, p, GPT_NEW_TOKENS, dev)
    n_swap, margin_swap = compare_greedy(swapped, ref2, logits2,
                                         "greedy stream after the swap")
    swap_ratio, swap_err = check_served_logits(
        srv, p, swapped, logits2, n_swap, "greedy stream after the swap")
    check(swapped != streams[0][1],
          "the swapped model generates the old model's stream")
    print("gpt weight swap (epoch %d): the stream equals the second model's "
          "generate over %d tokens (parted at a margin of %s); its logits "
          "within %.3f of the limit (max abs err %.4g)"
          % (epoch, n_swap, margin_swap, swap_ratio, swap_err), flush=True)
    del model2
    result = {"model": dict(GPT_CONFIG, dtype="bfloat16",
                            parameters=n_params),
              "slots": GPT_SLOTS, "top_k": GPT_TOP_K,
              "max_new_tokens": GPT_NEW_TOKENS, "bursts": timing,
              "prefills": prefills, "flash_prefills": flash_prefills,
              "prefix_hits": hits, "decode_steps": steps,
              "launches": launches, "step_programs": graphs,
              "greedy_tokens_compared": compared, "parted": len(parted),
              "parting_margins": parted,
              "median_top2_gap": float(np.median(gaps)),
              "greedy_tie_tol": GREEDY_TIE_TOL,
              "served_logits_vs_reference": logits_check,
              "prefill_vs_plain": prefills_vs_plain,
              "swap": {"epoch": epoch, "tokens_compared": n_swap,
                       "parting_margin": margin_swap,
                       "logits_worst_ratio": swap_ratio,
                       "logits_max_abs_err": swap_err},
              "server_stats": stats, "peak_memory_gb": peak_gb}
    return srv, model, result


def check_generate_launches(gen):
    """Exact launch counts of the serving run: 25 LayerNorm a prefill and a
    decode step (a prefix inject launches none), 12 flash forward a
    prefill at a bucket of 256 or more, no training kernel."""
    n = gen["launches"]
    want = {"layernorm": 25 * (gen["prefills"] + gen["decode_steps"]),
            "flash_attention_fwd": 12 * gen["flash_prefills"]}
    for name, count in n.items():
        check(count == want.get(name, 0), "gpt serving: %s launches %d, "
              "expected %d" % (name, count, want.get(name, 0)))


def phase_generate_launches(dev, srv):
    """Launches of single requests through the server: a prefill at bucket
    512 and at 128 (max_new_tokens 1: no decode step), a prefix hit of the
    first (no kernel), and one decode step (max_new_tokens 2)."""
    rng = np.random.RandomState(SEED + 8)
    long_p = rng.randint(0, GPT_CONFIG["vocab_size"], 400).astype(np.int32)
    short_p = rng.randint(0, GPT_CONFIG["vocab_size"], 100).astype(np.int32)
    out = {}
    with srv:
        for name, prompt, n_new in (("prefill bucket 512", long_p, 1),
                                    ("prefix inject", long_p, 1),
                                    ("prefill bucket 128", short_p, 1),
                                    ("prefill 128 + one decode step",
                                     short_p[::-1].copy(), 2)):
            reset_counters()
            srv.generate(prompt, max_new_tokens=n_new)
            out[name] = read_counters()
    want = {"prefill bucket 512": {"layernorm": 25,
                                   "flash_attention_fwd": 12},
            "prefix inject": {},
            "prefill bucket 128": {"layernorm": 25},
            "prefill 128 + one decode step": {"layernorm": 50}}
    print("gpt launches of single requests: %s" % out, flush=True)
    for name, counts in out.items():
        for k, n in counts.items():
            check(n == want[name].get(k, 0), "gpt %s: %s launches %d, "
                  "expected %d" % (name, k, n, want[name].get(k, 0)))
    return out


def _flash_fwd_f32_bound(B, H, T, D, vl, causal=False):
    """(operations, bytes) least times of the flash forward's fp32 form
    without the lse: two fp32-accurate products over the (query, key)
    pairs this run's data keeps (each example's valid keys; T (T + 1) / 2
    a head when causal), at the card's fastest fp32-accurate rate, 3xTF32
    on the tensor cores (PEAK_3XTF32, 165 TFLOP/s; on the CUDA cores,
    PEAK_FP32, it would be 67 TFLOP/s, so a 3xTF32 kernel never reads over
    100% of this bound); q read and o written whole, the kept rows of k
    and v."""
    if causal:
        pairs, keys = B * H * T * (T + 1) // 2, B * T
    else:
        pairs, keys = H * T * int(np.sum(vl)), int(np.sum(vl))
    nbytes = 4 * (2 * B * H * T * D + 2 * H * D * keys) + 4 * B
    return 4 * D * pairs / PEAK_3XTF32, nbytes / PEAK_BYTES


def _flash_causal_bound(B, H, T, D):
    """(operations, bytes) least times of a causal flash forward in bf16
    without the lse: each query row against the keys up to it (two
    products over T (T + 1) / 2 pairs), q, k, v read and o written once."""
    ops = 4 * B * H * D * T * (T + 1) // 2
    return ops / PEAK_BF16, 4 * B * H * T * D * 2 / PEAK_BYTES


def phase_generate_timing(dev, records, gen):
    """The two kernels of the generative path at its shapes, added to their
    records under ``generate``: LayerNorm at a decode step's (8, 768) rows
    (eps 1e-5), the causal flash forward of a prefill at buckets 256, 512
    and 1024 (batch 1), each held to its plain version and then timed
    against it, its library call and its bound. The launches a prefill and
    a decode step are the single requests' readings."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention, flash_attention_plain)
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    rec = {r["name"]: r for r in records}
    single = gen["single_requests"]
    prefill_128, prefill_512 = (single["prefill bucket 128"],
                                single["prefill bucket 512"])
    with_step = single["prefill 128 + one decode step"]
    inject = single["prefix inject"]
    C = GPT_CONFIG["units"]
    x = torch.randn(GPT_SLOTS, C, device=dev, generator=g).to(torch.bfloat16)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    reading = held(fused_layernorm(x, gamma, beta, 1e-5),
                   layernorm_plain(x, gamma, beta, 1e-5), BF16_TOL,
                   "gpt layernorm (%d, %d) bf16 eps 1e-05" % (GPT_SLOTS, C))
    t = time_ms(lambda: fused_layernorm(x, gamma, beta, 1e-5),
                lambda: layernorm_plain(x, gamma, beta, 1e-5),
                lambda: TF.layer_norm(x, (C,), gb, bb, 1e-5))
    t_ops, t_bytes = _ln_bound(GPT_SLOTS, C, 2)
    launches = gen["launches"]
    rec["layernorm_fwd"]["generate"] = {
        "launches": launches["layernorm"],
        "launches_per_prefill": prefill_512["layernorm"],
        "launches_per_decode_step": with_step["layernorm"]
        - prefill_128["layernorm"],
        "launches_per_prefix_inject": inject["layernorm"],
        "decode_step": dict(zip(("ms", "plain_ms", "library_ms"), t),
                            shape=[GPT_SLOTS, C], check=reading,
                            max_abs_err=reading["max_abs_err"],
                            bound_ms=max(t_ops, t_bytes) * 1e3,
                            bound_by="operations" if t_ops >= t_bytes
                            else "bytes")}
    causal = []
    H, D = GPT_CONFIG["num_heads"], GPT_CONFIG["units"] // \
        GPT_CONFIG["num_heads"]
    for T in (256, 512, 1024):
        q, k, v = _qkv(dev, g, 1, H, T, D)
        reading = held(flash_attention(q, k, v, causal=True),
                       flash_attention_plain(q, k, v, causal=True),
                       FLASH_TOL, "gpt flash causal (1, %d, %d, %d)"
                       % (H, T, D),
                       mag=flash_magnitude(q, k, v, causal=True))
        t = time_ms(lambda: flash_attention(q, k, v, causal=True),
                    lambda: flash_attention_plain(q, k, v, causal=True),
                    lambda: TF.scaled_dot_product_attention(q, k, v,
                                                            is_causal=True))
        t_ops, t_bytes = _flash_causal_bound(1, H, T, D)
        causal.append(dict(zip(("ms", "plain_ms", "library_ms"), t),
                           shape=[1, H, T, D], check=reading,
                           max_abs_err=reading["max_abs_err"],
                           bound_ms=max(t_ops, t_bytes) * 1e3,
                           bound_by="operations" if t_ops >= t_bytes
                           else "bytes"))
    rec["flash_attention_fwd"]["generate"] = {
        "launches": launches["flash_attention_fwd"],
        "launches_per_prefill_at_bucket_256_or_more":
            prefill_512["flash_attention_fwd"],
        "launches_per_prefill_below_256": prefill_128["flash_attention_fwd"],
        "launches_per_decode_step": with_step["flash_attention_fwd"]
        - prefill_128["flash_attention_fwd"],
        "launches_per_prefix_inject": inject["flash_attention_fwd"],
        "causal_prefill": causal,
        "library": "scaled_dot_product_attention(is_causal=True)"}
    for what, r in [("layernorm (%d, %d)" % (GPT_SLOTS, C),
                     rec["layernorm_fwd"]["generate"]["decode_step"])] + [
            ("flash causal %s" % c["shape"], c) for c in causal]:
        print("time gpt %-28s kernel %.4f ms, plain %.4f ms, library %.4f ms,"
              " bound %.5f ms (%s)" % (what, r["ms"], r["plain_ms"],
                                       r["library_ms"], r["bound_ms"],
                                       r["bound_by"]), flush=True)


# ------------------------------------------------- decode step programs
# each check runs GRAPH_STEPS decode steps each way from one saved state of
# 8 slots filled with GRAPH_PROMPTS (capacity 512 with 64 new tokens)
GRAPH_STEPS = 6
GRAPH_PROMPTS = (24, 40, 64, 100, 130, 200, 260, 300)
GRAPH_TIMED = 10  # host-wall samples of a step, each way
# LayerNorm launches a GPT decode step: ln1 and ln2 of each layer, ln_f
STEP_LN = 2 * GPT_CONFIG["num_layers"] + 1


def fill_slots(srv, prompts, temps, new_tokens):
    """Every slot taken by one request, prefilled and not yet decoded: the
    requests are submitted, the admission thread hands them over, and the
    server admits them (its loop is not running)."""
    streams = [srv.submit(p, max_new_tokens=new_tokens, temperature=t,
                          seed=i) for i, (p, t) in enumerate(zip(prompts,
                                                                 temps))]
    deadline = time.perf_counter() + 30.0
    while len(srv._join_q) < len(prompts) and time.perf_counter() < deadline:
        time.sleep(0.001)
    srv._admit_pending()
    check(srv.cache.num_active == len(prompts), "%d of %d slots filled"
          % (srv.cache.num_active, len(prompts)))
    return streams


def step_buffers(srv):
    """The tensors a decode step writes: input tokens, valid lengths, the
    K/V pages and (quantized) their scales."""
    c = srv.cache
    bufs = [srv._tok, c.valid] + c.k + c.v
    return bufs + c.k_scale + c.v_scale if c.quantize else bufs


def save_state(srv):
    return [t.clone() for t in step_buffers(srv)]


def restore_state(srv, saved):
    for dst, src in zip(step_buffers(srv), saved):
        dst.copy_(src)


def graph_against_eager(srv, what, n=GRAPH_STEPS):
    """:func:`program_against_eager` for the decode step: its logits (fp32)
    and next tokens, STEP_LN LayerNorm launches a step. Returns (the
    reading, the steady run's steps); the state is restored."""
    def step(eager):
        logits = srv._run_step(eager=eager)
        return [logits.float().clone(), srv._tok.clone()]

    reading, graph = program_against_eager(what, srv._steps, step,
                                           step_buffers(srv), STEP_LN, n)
    reading["key"] = list(map(str, (srv.cache.capacity, srv._sampling,
                                    srv._quantize)))
    return reading, graph


def step_walls(srv, n=GRAPH_TIMED):
    """Host wall (ms) of a decode step with its one readback, through the
    programs and eagerly in turns from one saved state, and the step's
    device-stream time from CUDA events (for a replay, the kernels back to
    back; for the eager step, the stream's span, idle gaps included):
    medians."""
    import torch

    saved = save_state(srv)
    out = {"graph": [], "eager": [], "graph_events": [], "eager_events": []}
    for _ in range(n):
        for way, eager in (("graph", False), ("eager", True)):
            restore_state(srv, saved)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            srv._run_step(eager=eager)
            end.record()
            srv._tok.cpu()
            out[way].append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            out[way + "_events"].append(start.elapsed_time(end))
    restore_state(srv, saved)
    return {k: float(np.median(v)) for k, v in out.items()}


def _swap_file(dev, seed, quantize):
    """A second model's parameters (quantized like the served one) saved
    to a file under the build directory; returns its path."""
    import tempfile

    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.quantization import quantize_model

    other = _gpt_model(dev, seed)
    if quantize:
        quantize_model(other, mode=quantize)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(tempfile.mkdtemp(dir=_build.BUILD_DIR),
                        "gpt2_seed%d.params" % seed)
    other.save_parameters(path)
    return path


def phase_graph(dev):
    """The decode step through its CUDA graphs against the same step run
    eagerly, bf16 and int8: 8 slots filled, then from one saved state
    greedy, sampled (every other slot at temperature 0.8), after a capacity
    migration (512 -> 1024: every program dropped) and after a weight swap
    (no program dropped; the replay must give the new weights' logits).
    Then the host wall of a step each way, and the verify step, the draft
    round and a prefill chunk against their eager runs
    (:func:`spec_programs_against_eager`)."""
    import shutil

    import torch
    from mxnet_tpu_torch.serve import GenerativeServer

    rng = np.random.RandomState(SEED + 11)
    prompts = [rng.randint(0, GPT_CONFIG["vocab_size"], n).astype(np.int32)
               for n in GRAPH_PROMPTS]
    sampled = [0.8 if i % 2 else 0.0 for i in range(GPT_SLOTS)]
    out = {}
    for mode in (None, "int8"):
        name = "gpt decode step %s" % (mode or "bf16")
        model = _gpt_model(dev, SEED + 12)
        srv = GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                               prefix_cache=False, timeout_ms=600000.0,
                               device=dev, quantize=mode)
        fill_slots(srv, prompts, [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
        r = {"greedy": graph_against_eager(srv, name + " greedy")[0]}
        srv._temps[:] = sampled
        srv._ctl_dirty = True
        r["sampled"] = graph_against_eager(srv, name + " sampled")[0]
        cap, drops = srv.cache.capacity, srv._steps.drops
        srv.cache.ensure_capacity(GPT_CONFIG["max_length"])
        r["after_migration"] = graph_against_eager(
            srv, name + " sampled, capacity %d -> %d"
            % (cap, srv.cache.capacity))[0]
        check(srv._steps.drops == drops + 1 and srv.cache.capacity > cap,
              "%s: the migration did not drop the programs" % name)
        path = _swap_file(dev, SEED + 13, mode)
        try:
            saved = save_state(srv)
            old = srv._run_step().float().clone()
            restore_state(srv, saved)
            captures, drops = srv._steps.captures, srv._steps.drops
            epoch = srv.swap_parameters(path)
        finally:
            shutil.rmtree(os.path.dirname(path))
        r["after_swap"], steps = graph_against_eager(
            srv, name + " after a weight swap (epoch %d)" % epoch)
        check(not torch.equal(steps[0][0], old),
              "%s: the replayed step still serves the old weights" % name)
        check(srv._steps.captures == captures and srv._steps.drops == drops,
              "%s: the swap made or dropped programs" % name)
        r["host_wall_ms"] = step_walls(srv)
        r["speculative"] = spec_programs_against_eager(dev, model, mode,
                                                       prompts)
        r["programs"] = {"captures": srv._steps.captures,
                         "replays": srv._steps.replays,
                         "drops": srv._steps.drops,
                         "keys": [list(map(str, k))
                                  for k in srv._steps.keys()]}
        print("%s: host wall of a step with its readback, median of %d: "
              "graph %.3f ms, eager %.3f ms; CUDA-event span graph %.3f ms, "
              "eager %.3f ms" % (name, GRAPH_TIMED,
                                 r["host_wall_ms"]["graph"],
                                 r["host_wall_ms"]["eager"],
                                 r["host_wall_ms"]["graph_events"],
                                 r["host_wall_ms"]["eager_events"]),
              flush=True)
        srv.stop()
        out[mode or "bf16"] = r
        del srv, model
        torch.cuda.empty_cache()
    return out


# ------------------------------------------------- speculative decode
# the verify window (tokens scored a verify step)
SPEC_K = 4
# the speculative burst: six repetitive prompts, a pattern of 16-64 tokens
# repeated to 200-900 tokens ((pattern, length, temperature, seed)), and the
# first six requests of phase_generate's first burst (random prompts); 64
# new tokens each
SPEC_REPEATS = ((16, 200, 0, 0), (32, 450, 0.8, 31), (64, 900, 0, 0),
                (24, 300, 0, 0), (48, 600, 0.8, 32), (40, 260, 0, 0))
SPEC_DRAFT_LAYERS = 2
# LayerNorm launches of the 2-layer draft: a round is SPEC_K decode steps
# (two a layer and ln_f each), a fill one forward
DRAFT_ROUND_LN = SPEC_K * (2 * SPEC_DRAFT_LAYERS + 1)
DRAFT_FILL_LN = 2 * SPEC_DRAFT_LAYERS + 1
# the greedy accept rate of a draft that is the target itself: each draft
# is the target's own greedy token, computed by the plain step (8 rows)
# where the verify step computes it among 8 x SPEC_K rows, so a bf16 draft
# differs from the verify's sample only at a near-tie of the two bf16
# computations (and of the K/V each wrote, rounded apart). With random
# weights the logits lie close (a bf16 step is 2**-7 of them), so such
# ties are common: 0.9412 (384 of 408 drafts) on the card; the floor is
# 0.9, where a draft that is not the target's greedy token (a 2-layer
# one reads 0) is far below
SELF_DRAFT_ACCEPT_FLOOR = 0.9
# int8: a speculative stream against the plain int8 server's may part
# where the plain server's token led by less than this. An int8 step's
# logits move with the rest of its batch: each quantized Dense quantizes
# its activations with one scale over every row of the step (the verify's
# 8 x SPEC_K rows, the drafts and free slots included; the plain step's
# 8), and a drafted row that is later rejected may raise its page's
# running-max scale (as in the JAX package), so the two differ by the
# int8 step's quantization noise, not by bf16 rounding. Twice the largest
# margin met at an int8 parting on the card (0.0714, a chunked stream;
# 0.0629 a speculative one)
INT8_TIE_TOL = 0.15
# chunked prefill: four streams decode while a 900-token prompt joins in
# chunks of 256
CHUNK = 256
CHUNK_INFLIGHT = (20, 40, 60, 100)
CHUNK_JOINER = 900


def _spec_requests(vocab):
    """[(prompt int32, temperature, seed)]: the six repetitive prompts,
    then six random ones."""
    rng = np.random.RandomState(SEED + 30)
    reqs = [(np.resize(rng.randint(0, vocab, pat), n).astype(np.int32),
             temp, seed) for pat, n, temp, seed in SPEC_REPEATS]
    return reqs + _gpt_requests(vocab)[0][:6]


def _gen_server(model, dev, **kw):
    from mxnet_tpu_torch.serve import GenerativeServer

    kw.setdefault("prefix_cache", False)
    return GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                            timeout_ms=600000.0, device=dev, **kw)


def _draft_model(dev, seed):
    """A 2-layer GPT at GPT-2 small's widths (vocab 50257, max_length
    1024), random weights from a seed, bf16 via amp."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.gpt import GPTModel

    model = GPTModel(dropout=0.1, **dict(GPT_CONFIG,
                                         num_layers=SPEC_DRAFT_LAYERS))
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    amp.convert_hybrid_block(model, "bfloat16")
    return model


def _req_key(prompt, temp, seed):
    """A request's key: (prompt bytes, temperature, seed)."""
    return (np.asarray(prompt, np.int32).tobytes(), float(temp), int(seed))


def _stream_key(stream):
    return _req_key(stream.prompt, stream.temperature, stream.seed)


class record_logits:
    """Within the block, the logits a plain server sampled each token of
    each stream from, fp32 on the device: {(prompt bytes, temperature,
    seed): [one (V,) row a token]} (the prefill's last row, then the
    stream's row of each decode step). Two device copies a step."""

    def __init__(self, srv):
        self.srv = srv
        self.rows = {}

    def __enter__(self):
        srv, rows = self.srv, self.rows
        prefill, run_step = srv._prefill, srv._run_step

        def pre(slot, *args, **kwargs):
            out = prefill(slot, *args, **kwargs)
            rows.setdefault(_stream_key(srv.cache.owner(slot)), []).append(
                out[1].float().clone())
            return out

        def step(*args, **kwargs):
            logits = run_step(*args, **kwargs)
            full = logits.float().clone()
            for s in np.flatnonzero(srv._active_mask()):
                rows[_stream_key(srv.cache.owner(int(s)))].append(
                    full[int(s)])
            return logits

        srv._prefill, srv._run_step = pre, step
        return self

    def __exit__(self, *exc):
        del self.srv._prefill, self.srv._run_step


def sampler_margin(row, a, b, temp, seed, position):
    """How far the plain server's logits ``row`` at a step would have to
    move for it to take the token ``a`` a stream took instead of its own
    ``b``, in logit units: for a greedy step the logits' difference; for a
    sampled one, either ``a``'s sampler score (logit / temp plus its Gumbel
    noise at (seed, position), the same on both servers) rises past
    ``b``'s, once ``a`` is inside the top-k cut, or ``b`` falls below the
    cut (then ``a`` may win among the rest)."""
    import torch
    from mxnet_tpu_torch.serve.decoder import gumbel_noise

    lg = row.float()
    if temp <= 0:
        return float(lg[b] - lg[a])
    noise = gumbel_noise(torch.tensor([seed], device=lg.device),
                         torch.tensor([position], device=lg.device),
                         lg.numel())[0]
    score = lg / temp + noise
    kth = float(torch.topk(lg, GPT_TOP_K).values[-1])
    below = max(kth - float(lg[a]), 0.0)   # a's way into the top-k
    by_score = max(float((score[b] - score[a]) * temp), below)
    by_cut = max(float(lg[b]) - kth, below)
    return min(by_score, by_cut)


def compare_to_plain(got, plain, rows, req, what, tol=GREEDY_TIE_TOL):
    """(tokens compared, the margin where ``got`` parted from the plain
    server's stream or None): equal up to a step where the plain server's
    own token led the other by less than ``tol`` (:func:`sampler_margin`),
    after which the stream is not compared."""
    prompt, temp, seed = req
    for i, (a, b) in enumerate(zip(got, plain)):
        if a != b:
            margin = sampler_margin(rows[i], a, b, temp, seed,
                                    len(prompt) + i)
            check(margin < tol,
                  "%s: token %d is %d, the plain server's %d (margin %.4f "
                  ">= %g)" % (what, i, a, b, margin, tol))
            return i + 1, margin
    check(len(got) == len(plain), "%s: %d tokens, the plain server's %d"
          % (what, len(got), len(plain)))
    return len(got), None


def reopen(srv):
    """Admission of a server that ``with srv:`` stopped, reopened without
    its loop: the caller drives the ticks (``stop()`` closes it again)."""
    srv._stop_flag = False


def redrive_parted(plain_srv, req, plain, got, n, what):
    """A bf16 greedy stream that parted from the plain server's at token
    n - 1, the plain one driven again alone (its step runs every slot, so
    a slot's row does not depend on the others): the same tokens, and its
    own logits put the two tokens within GREEDY_TIE_TOL. Returns that
    margin."""
    toks, logits = served_logits(plain_srv, req[0], n)
    check(toks == list(plain[:n]), "%s: the plain server, driven alone, "
          "gives other tokens than among companions" % what)
    row = logits[n - 1]
    margin = float(row[plain[n - 1]] - row[got[n - 1]])
    check(margin < GREEDY_TIE_TOL, "%s: driven alone, the plain server's "
          "token leads by %.4f >= %g" % (what, margin, GREEDY_TIE_TOL))
    return margin


def compare_streams(reqs, got, plain, rows, what, plain_srv=None,
                    tol=GREEDY_TIE_TOL):
    """Every stream of ``got`` against the plain server's (compare_to_plain);
    a parted bf16 greedy stream is also re-driven alone on ``plain_srv``.
    Returns {compared, parted, margins}."""
    out = {"compared": 0, "parted": 0, "margins": [], "tol": tol}
    for req, g, p in zip(reqs, got, plain):
        label = "%s (prompt %d, temperature %g)" % (what, len(req[0]),
                                                    req[1])
        n, margin = compare_to_plain(g, p, rows[_req_key(*req)], req,
                                     label, tol)
        out["compared"] += n
        if margin is not None:
            out["parted"] += 1
            out["margins"].append(margin)
            if plain_srv is not None and not req[1]:
                out.setdefault("redriven_margins", []).append(
                    redrive_parted(plain_srv, req, p, g, n, label))
    return out


def timed_row0(spec, plain):
    """The verify step's first row against the plain step, slot by slot of
    the same prompt, each from its server's saved state (the same prompts
    prefilled): max and mean |logit| difference, and whether the argmax is
    the same everywhere; the states are restored."""
    import torch

    out = {}
    for srv, run in ((spec, lambda: spec._run_verify()[:, 0]),
                     (plain, lambda: plain._run_step())):
        bufs = step_buffers(srv)
        saved = [t.clone() for t in bufs]
        logits = run().float().clone()
        out[srv is spec] = {srv.cache.owner(s).prompt.tobytes(): logits[s]
                            for s in srv.cache.active_slots}
        for dst, src in zip(bufs, saved):
            dst.copy_(src)
    a = torch.stack([out[True][k] for k in sorted(out[False])])
    b = torch.stack([out[False][k] for k in sorted(out[False])])
    diff = (a - b).abs()
    return {"max_abs_diff": float(diff.max()),
            "mean_abs_diff": float(diff.mean()),
            "max_abs_logit": float(b.abs().max()),
            "argmax_equal": bool(torch.equal(a.argmax(-1), b.argmax(-1)))}


def timed_rounds(srv, run, n=GRAPH_TIMED):
    """Host wall (ms) of ``run`` with its readback, from one saved state,
    median of n."""
    import torch

    bufs = step_buffers(srv) + [srv._emit, srv._drafts]
    saved = [t.clone() for t in bufs]
    walls = []
    for _ in range(n):
        for dst, src in zip(bufs, saved):
            dst.copy_(src)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        walls.append((time.perf_counter() - t0) * 1e3)
    for dst, src in zip(bufs, saved):
        dst.copy_(src)
    return float(np.median(walls))


def phase_speculative(dev):
    """Speculative decode of GPT-2 small (see the module docstring): the
    burst of SPEC_REPEATS and six random prompts through a plain server
    (its logits recorded), then with NGramDraft, a ModelDraft of the target
    itself (greedy requests), a 2-layer ModelDraft, and int8 with
    NGramDraft against a plain int8 server; each speculative run is a main
    path with every counter at 0 just before it. Returns (the result, the
    bf16 and int8 plain servers with their models)."""
    import torch
    from mxnet_tpu_torch.base import next_pow2
    from mxnet_tpu_torch.serve import ModelDraft, NGramDraft

    t0 = time.perf_counter()
    vocab = GPT_CONFIG["vocab_size"]
    reqs = _spec_requests(vocab)
    greedy = [r for r in reqs if not r[1]]
    buckets = warm_prompts([reqs])
    max_tokens = GPT_CONFIG["max_length"] - SPEC_K + 1
    out = {"spec_k": SPEC_K, "requests": len(reqs)}
    plains = {}

    def spec_run(srv, burst, what):
        srv.warmup(prompt_buckets=warm_prompts([burst]),
                   max_tokens=max_tokens)
        torch.cuda.synchronize()
        m0 = srv.stats()
        draft_steps = getattr(srv._draft, "_steps", None)
        d0 = (draft_steps.captures, draft_steps.replays) if draft_steps \
            else (0, 0)
        # this path's run, every counter at 0 just before it
        reset_counters()
        streams, timing = serve_bursts(srv, [burst], GPT_NEW_TOKENS, what)
        torch.cuda.synchronize()
        launches = read_counters()
        st = srv.stats()
        rounds = st["spec_rounds"] - m0["spec_rounds"]
        r = {"launches": launches, "rounds": rounds,
             "prefills": st["prefills"] - m0["prefills"],
             "tokens_per_s": timing[0]["tokens_per_s"],
             "wall_s": timing[0]["wall_s"], "tokens": timing[0]["tokens"],
             "drafted": st["drafted_tokens"] - m0["drafted_tokens"],
             "accepted": st["accepted_tokens"] - m0["accepted_tokens"],
             "captures": st["step_captures"] - m0["step_captures"],
             "replays": st["step_replays"] - m0["step_replays"],
             "itl_p50_ms": st["itl_p50_ms"]}
        r["accept_rate"] = r["accepted"] / max(r["drafted"], 1)
        if draft_steps:
            r["draft_captures"] = draft_steps.captures - d0[0]
            r["draft_replays"] = draft_steps.replays - d0[1]
        check(st["errors"] == 0 and st["timeouts"] == 0,
              "%s: serving errors %s" % (what, st))
        check(r["captures"] == 0 and r["replays"] == rounds > 0,
              "%s: %d captures and %d verify replays over %d rounds"
              % (what, r["captures"], r["replays"], rounds))
        if draft_steps:
            check(r["draft_captures"] == 0 and r["draft_replays"] == rounds,
                  "%s: the draft's program: %d captures, %d replays over %d "
                  "rounds" % (what, r["draft_captures"], r["draft_replays"],
                              rounds))
        for s in streams[0]:
            check(len(s) == GPT_NEW_TOKENS
                  and all(0 <= t < vocab for t in s),
                  "%s: a stream of %d tokens or a token out of range"
                  % (what, len(s)))
        print("%s: %d rounds, %d prefills, accept rate %.4f (%d of %d "
              "drafts), %.1f tokens/s; verify programs %d captures, %d "
              "replays; kernel launches %s" % (
                  what, rounds, r["prefills"], r["accept_rate"],
                  r["accepted"], r["drafted"], r["tokens_per_s"],
                  r["captures"], r["replays"], launches), flush=True)
        return streams[0], r

    for mode in (None, "int8"):
        name = mode or "bf16"
        model = _gpt_model(dev, SEED)
        plain = _gen_server(model, dev, quantize=mode)
        plain.warmup(prompt_buckets=buckets,
                     max_tokens=GPT_CONFIG["max_length"])
        with record_logits(plain) as rec:
            base, base_t = serve_bursts(plain, [reqs], GPT_NEW_TOKENS,
                                        "gpt %s plain (logits recorded)"
                                        % name)
        plains[name] = (plain, model)
        res = {"plain_tokens_per_s": base_t[0]["tokens_per_s"]}
        srv = _gen_server(model, dev, quantize=mode, draft=NGramDraft(),
                          spec_k=SPEC_K)
        got, r = spec_run(srv, reqs, "gpt %s NGramDraft" % name)
        flash = "flash_attention_fwd_f32" if mode else "flash_attention_fwd"
        at_256 = sum(next_pow2(len(p)) >= 256 for p, _, _ in reqs)
        want = {"layernorm": STEP_LN * (r["prefills"] + r["rounds"]),
                flash: GPT_CONFIG["num_layers"] * at_256}
        for k, n in r["launches"].items():
            check(n == want.get(k, 0), "%s NGramDraft: %s launches %d, "
                  "expected %d" % (name, k, n, want.get(k, 0)))
        r["vs_plain"] = compare_streams(
            reqs, got, base[0], rec.rows, "gpt %s NGramDraft" % name,
            plain_srv=None if mode else plain,
            tol=INT8_TIE_TOL if mode else GREEDY_TIE_TOL)
        print("gpt %s NGramDraft vs the plain server: %s" % (
            name, r["vs_plain"]), flush=True)
        # one verify step and one plain step from 8 live slots, the same
        # prompts on both: the verify's first row against the plain step,
        # launches, and host walls with the readback
        for s in (srv, plain):
            reopen(s)
            fill_slots(s, [p for p, _, _ in reqs[:GPT_SLOTS]],
                       [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
        srv._propose(srv._active_mask())
        # the same token at the same position, computed among 8 x SPEC_K
        # rows (int8: under another activation scale, into pages whose
        # scale the drafts' rows may raise)
        r["verify_row0_vs_plain_step"] = timed_row0(srv, plain)
        saved = save_state(srv)
        reset_counters()
        srv._run_verify()
        torch.cuda.synchronize()
        r["launches_per_verify_step"] = read_counters()
        restore_state(srv, saved)
        check(r["launches_per_verify_step"]["layernorm"] == STEP_LN
              and not r["launches_per_verify_step"][flash],
              "%s: a verify step launched %s, expected %d LayerNorm and no "
              "flash" % (name, r["launches_per_verify_step"], STEP_LN))
        r["verify_host_wall_ms"] = timed_rounds(
            srv, lambda: (srv._run_verify(), srv._emit.cpu()))
        r["plain_step_host_wall_ms"] = timed_rounds(
            plain, lambda: (plain._run_step(), plain._tok.cpu()))
        print("gpt %s: the verify step's first row against the plain step "
              "on the same 8 prompts: %s" % (
                  name, r["verify_row0_vs_plain_step"]), flush=True)
        srv.stop()
        plain.stop()
        print("gpt %s: verify step (8 slots x %d rows) host wall %.3f ms, "
              "plain step %.3f ms (medians of %d, readback included); "
              "tokens/s %.1f with NGramDraft, %.1f plain" % (
                  name, SPEC_K, r["verify_host_wall_ms"],
                  r["plain_step_host_wall_ms"], GRAPH_TIMED,
                  r["tokens_per_s"], res["plain_tokens_per_s"]), flush=True)
        res["ngram"] = r
        del srv
        if mode is None:
            # a ModelDraft of the target itself, greedy requests: every
            # draft is the target's own greedy token
            srv = _gen_server(model, dev, draft=model, spec_k=SPEC_K)
            got, r = spec_run(srv, greedy, "gpt bf16 ModelDraft(target)")
            r["vs_plain"] = compare_streams(
                greedy, got, [s for s, q in zip(base[0], reqs) if not q[1]],
                rec.rows, "gpt bf16 ModelDraft(target)", plain_srv=plain)
            check(r["accept_rate"] >= SELF_DRAFT_ACCEPT_FLOOR,
                  "the target as its own draft accepts %.4f of its greedy "
                  "drafts (floor %g)" % (r["accept_rate"],
                                         SELF_DRAFT_ACCEPT_FLOOR))
            res["self_draft"] = r
            srv.stop()
            del srv
            # a 2-layer draft at the same widths
            draft = ModelDraft(_draft_model(dev, SEED + 20))
            srv = _gen_server(model, dev, draft=draft, spec_k=SPEC_K)
            got, r = spec_run(srv, reqs, "gpt bf16 ModelDraft(2 layers)")
            fills = len(reqs)
            fill_256 = sum(min(next_pow2(len(p)), srv.cache.capacity) >= 256
                           for p, _, _ in reqs)
            want = {"layernorm": STEP_LN * (r["prefills"] + r["rounds"])
                    + DRAFT_FILL_LN * fills + DRAFT_ROUND_LN * r["rounds"],
                    "flash_attention_fwd": GPT_CONFIG["num_layers"] * at_256
                    + SPEC_DRAFT_LAYERS * fill_256}
            for k, n in r["launches"].items():
                check(n == want.get(k, 0), "2-layer draft: %s launches %d, "
                      "expected %d" % (k, n, want.get(k, 0)))
            r["vs_plain"] = compare_streams(
                reqs, got, base[0], rec.rows, "gpt bf16 ModelDraft(2 layers)",
                plain_srv=plain)
            # one draft round and one fill at bucket 512, alone
            reopen(srv)
            fill_slots(srv, [p for p, _, _ in reqs[:GPT_SLOTS]],
                       [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
            reset_counters()
            srv._propose(srv._active_mask())
            torch.cuda.synchronize()
            r["launches_per_draft_round"] = read_counters()
            reset_counters()
            draft.join(0, reqs[1][0])   # 450 tokens: bucket 512
            torch.cuda.synchronize()
            r["launches_per_draft_fill_512"] = read_counters()
            check(r["launches_per_draft_round"]["layernorm"]
                  == DRAFT_ROUND_LN
                  and not r["launches_per_draft_round"][
                      "flash_attention_fwd"],
                  "a draft round launched %s, expected %d LayerNorm"
                  % (r["launches_per_draft_round"], DRAFT_ROUND_LN))
            check(r["launches_per_draft_fill_512"]["flash_attention_fwd"]
                  == SPEC_DRAFT_LAYERS
                  and r["launches_per_draft_fill_512"]["layernorm"]
                  == DRAFT_FILL_LN,
                  "a draft fill at bucket 512 launched %s"
                  % r["launches_per_draft_fill_512"])
            r["draft_round_host_wall_ms"] = timed_rounds(
                srv, lambda: (srv._propose(srv._active_mask()),
                              srv._drafts.cpu()))
            srv.stop()
            print("gpt bf16 ModelDraft(2 layers): launches a round %s, a "
                  "fill at bucket 512 %s; round host wall %.3f ms; vs the "
                  "plain server %s" % (
                      r["launches_per_draft_round"],
                      r["launches_per_draft_fill_512"],
                      r["draft_round_host_wall_ms"], r["vs_plain"]),
                  flush=True)
            res["draft_2_layers"] = r
            del srv, draft
        out[name] = res
        torch.cuda.empty_cache()
    out["set_up_and_run_s"] = time.perf_counter() - t0
    print("phase_speculative: %.1f s" % out["set_up_and_run_s"], flush=True)
    return out, plains


def print_spec_summary(spec, chunked, card):
    """The speculative and chunked readings on one line with the card's
    name and power limit."""
    bf, q = spec["bf16"], spec["int8"]
    print("speculative decode and chunked prefill on %s: accept rate "
          "NGramDraft bf16 %.4f int8 %.4f, the target as its own draft %.4f, "
          "2-layer draft %.4f; verify / plain step host wall bf16 %.3f / "
          "%.3f ms, int8 %.3f / %.3f ms; tokens/s with / without NGramDraft "
          "bf16 %.1f / %.1f, int8 %.1f / %.1f; the longest tick while 900 "
          "tokens join, chunked / unchunked: bf16 %.3f / %.3f ms, int8 %.3f "
          "/ %.3f ms; itl_prefill p50 bf16 %s ms, int8 %s ms" % (
              card, bf["ngram"]["accept_rate"], q["ngram"]["accept_rate"],
              bf["self_draft"]["accept_rate"],
              bf["draft_2_layers"]["accept_rate"],
              bf["ngram"]["verify_host_wall_ms"],
              bf["ngram"]["plain_step_host_wall_ms"],
              q["ngram"]["verify_host_wall_ms"],
              q["ngram"]["plain_step_host_wall_ms"],
              bf["ngram"]["tokens_per_s"], bf["plain_tokens_per_s"],
              q["ngram"]["tokens_per_s"], q["plain_tokens_per_s"],
              chunked["bf16"]["stall_ms_chunked"],
              chunked["bf16"]["stall_ms_unchunked"],
              chunked["int8"]["stall_ms_chunked"],
              chunked["int8"]["stall_ms_unchunked"],
              chunked["bf16"]["itl_prefill_p50_ms"],
              chunked["int8"]["itl_prefill_p50_ms"]), flush=True)


def tick_drive(srv, inflight, joiner, new, seeds=(0, 1, 2, 3)):
    """Tick by tick from this thread: the in-flight prompts submitted and
    admitted, two ticks, then the joiner submitted; then ticks, each timed
    (host wall, its readback included), until every stream finishes.
    Returns (the streams' tokens, the joiner's last, and per tick: wall,
    chunks run, tokens gained by each in-flight stream, joiner tokens)."""
    import torch

    streams = [srv.submit(p, max_new_tokens=new, seed=s)
               for p, s in zip(inflight, seeds)]
    deadline = time.perf_counter() + 30.0
    while len(srv._join_q) < len(inflight) \
            and time.perf_counter() < deadline:
        time.sleep(0.001)
    srv.step()
    srv.step()
    late = srv.submit(joiner, max_new_tokens=new, seed=9)
    while not srv._join_q and time.perf_counter() < deadline + 30.0:
        time.sleep(0.001)
    ticks = []
    for _ in range(4 * new):
        before = [len(s.tokens) for s in streams]
        c0 = srv.metrics.prefill_chunks
        t0 = time.perf_counter()
        srv.step()
        torch.cuda.synchronize()
        ticks.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "chunks": srv.metrics.prefill_chunks - c0,
                      "gains": [len(s.tokens) - b
                                for s, b in zip(streams, before)],
                      "joiner_tokens": len(late.tokens)})
        if late.done() and all(s.done() for s in streams):
            break
    streams.append(late)
    check(all(s.done() for s in streams), "tick drive: streams left")
    return [s.result(1) for s in streams], ticks


def phase_chunked_prefill(dev, plains):
    """Chunked prefill (prefill_chunk=256): four streams decoding, then a
    900-token prompt joins; the same ticks on the plain server of
    phase_speculative (its logits recorded), bf16 and int8. Each chunked
    run is a main path with every counter at 0 just before it."""
    import torch

    rng = np.random.RandomState(SEED + 40)
    vocab = GPT_CONFIG["vocab_size"]
    inflight = [rng.randint(0, vocab, n).astype(np.int32)
                for n in CHUNK_INFLIGHT]
    joiner = rng.randint(0, vocab, CHUNK_JOINER).astype(np.int32)
    reqs = [(p, 0.0, s) for p, s in zip(inflight, range(4))] + [
        (joiner, 0.0, 9)]
    n_chunks = -(-CHUNK_JOINER // CHUNK)
    out = {"prefill_chunk": CHUNK, "joiner": CHUNK_JOINER,
           "inflight": list(CHUNK_INFLIGHT)}
    for name in ("bf16", "int8"):
        plain, model = plains[name]
        mode = None if name == "bf16" else "int8"
        flash = "flash_attention_fwd_f32" if mode else "flash_attention_fwd"
        srv = _gen_server(model, dev, quantize=mode, prefill_chunk=CHUNK)
        srv.warmup(prompt_buckets=warm_prompts([[(p, 0, 0)
                                                 for p in inflight]]),
                   max_tokens=GPT_CONFIG["max_length"])
        torch.cuda.synchronize()
        m0 = srv.stats()
        # this path's run, every counter at 0 just before it
        reset_counters()
        got, ticks = tick_drive(srv, inflight, joiner, GPT_NEW_TOKENS)
        launches = read_counters()
        st = srv.stats()
        chunks = st["prefill_chunks"] - m0["prefill_chunks"]
        steps = st["decode_steps"] - m0["decode_steps"]
        prefills = st["prefills"] - m0["prefills"]
        check(chunks == n_chunks, "%s: %d chunks for %d tokens, expected %d"
              % (name, chunks, CHUNK_JOINER, n_chunks))
        check(st["step_captures"] == m0["step_captures"],
              "%s: the chunked run captured a program" % name)
        # prefills: the four whole (short) prompts and the chunked one
        want = {"layernorm": STEP_LN * (prefills - 1 + chunks + steps)}
        for k, n in launches.items():
            check(n == want.get(k, 0), "%s chunked: %s launches %d, "
                  "expected %d" % (name, k, n, want.get(k, 0)))
        chunk_ticks = [t for t in ticks if t["chunks"]]
        for i in range(len(inflight)):
            gained = sum(t["gains"][i] > 0 for t in chunk_ticks)
            check(gained >= 3, "%s: in-flight stream %d gained a token on "
                  "%d of the %d chunk ticks" % (name, i, gained,
                                                len(chunk_ticks)))
        reopen(plain)
        with record_logits(plain) as rec:
            ref, ref_ticks = tick_drive(plain, inflight, joiner,
                                        GPT_NEW_TOKENS)
        cmp = compare_streams(reqs, got, ref, rec.rows,
                              "gpt %s chunked" % name,
                              plain_srv=plain if mode is None else None,
                              tol=INT8_TIE_TOL if mode else GREEDY_TIE_TOL)

        def joining(ts):
            # the ticks from the joiner's submission to its first token
            end = next(i for i, t in enumerate(ts) if t["joiner_tokens"])
            return ts[:end + 1]

        r = {"chunks": chunks, "launches": launches, "vs_unchunked": cmp,
             "chunk_tick_walls_ms": [t["wall_ms"] for t in chunk_ticks],
             "gains_on_chunk_ticks": [t["gains"] for t in chunk_ticks],
             "stall_ms_chunked": max(t["wall_ms"] for t in joining(ticks)),
             "stall_ms_unchunked": max(t["wall_ms"]
                                       for t in joining(ref_ticks)),
             "tick_ms_median_after_join": float(np.median(
                 [t["wall_ms"] for t in ticks[len(joining(ticks)):][:20]])),
             "itl_prefill_p50_ms": st["itl_prefill_p50_ms"],
             "itl_prefill_p99_ms": st["itl_prefill_p99_ms"],
             "itl_p50_ms": st["itl_p50_ms"]}
        print("gpt %s chunked prefill (%d tokens joining 4 streams, chunks "
              "of %d): %d chunks; chunk ticks %s ms; in-flight tokens "
              "gained on them %s; longest tick while it joins: chunked "
              "%.3f ms, unchunked %.3f ms; itl_prefill p50 %s p99 %s ms, "
              "itl p50 %s ms; vs the unchunked server %s; launches %s"
              % (name, CHUNK_JOINER, CHUNK, chunks,
                 [round(w, 3) for w in r["chunk_tick_walls_ms"]],
                 r["gains_on_chunk_ticks"], r["stall_ms_chunked"],
                 r["stall_ms_unchunked"], r["itl_prefill_p50_ms"],
                 r["itl_prefill_p99_ms"], r["itl_p50_ms"], cmp, launches),
              flush=True)
        out[name] = r
        srv.stop()
        plain.stop()
        del srv
    return out


def program_against_eager(what, steps, run, buffers, ln_per_run,
                          n=GRAPH_STEPS):
    """A step through its programs against the same step run eagerly:
    from one saved state of ``buffers``, n runs through the programs (the
    first may capture), n again (the steady state: no capture, one replay
    a run) and n eager runs; ``run(eager)`` returns the tensors to compare
    (copies, the logits first), which must be bitwise equal, with
    ``ln_per_run`` LayerNorm launches a run both ways. Returns (the
    reading, the steady runs); the state is restored."""
    import torch

    saved = [t.clone() for t in buffers]

    def restore():
        for dst, src in zip(buffers, saved):
            dst.copy_(src)

    def runs(eager):
        got = [run(eager) for _ in range(n)]
        torch.cuda.synchronize()
        return got

    def same(a, b):
        return all(torch.equal(x, y) for ra, rb in zip(a, b)
                   for x, y in zip(ra, rb))

    c0 = steps.captures
    first = runs(False)
    first_captures = steps.captures - c0
    restore()
    c1, r1 = steps.captures, steps.replays
    reset_counters()
    graph = runs(False)
    g_launch = read_counters()
    captures, replays = steps.captures - c1, steps.replays - r1
    restore()
    reset_counters()
    eager = runs(True)
    e_launch = read_counters()
    restore()
    reading = {"runs": n, "first_run_captures": first_captures,
               "steady_captures": captures, "steady_replays": replays,
               "graph_equals_eager": same(graph, eager),
               "capturing_run_equals_steady": same(first, graph),
               "max_abs_logit_diff": max(float((x[0] - y[0]).abs().max())
                                         for x, y in zip(graph, eager)),
               "launches_graph": g_launch, "launches_eager": e_launch}
    print("%s: graph vs eager over %d runs: bitwise equal %s (capturing run "
          "%s), max |logit diff| %.3g; captures %d then %d, replays %d; "
          "LayerNorm launches graph %d, eager %d" % (
              what, n, reading["graph_equals_eager"],
              reading["capturing_run_equals_steady"],
              reading["max_abs_logit_diff"], first_captures, captures,
              replays, g_launch["layernorm"], e_launch["layernorm"]),
          flush=True)
    check(reading["graph_equals_eager"], "%s: the captured runs differ from "
          "the eager ones" % what)
    check(reading["capturing_run_equals_steady"], "%s: the run that "
          "captured differs from the steady one" % what)
    check(captures == 0 and replays == n, "%s: %d captures and %d replays "
          "over %d steady runs" % (what, captures, replays, n))
    check(g_launch["layernorm"] == ln_per_run * n and g_launch == e_launch,
          "%s: launches under replay %s, eager %s, expected %d LayerNorm"
          % (what, g_launch, e_launch, ln_per_run * n))
    return reading, graph


def spec_programs_against_eager(dev, model, mode, prompts):
    """The verify step (greedy and sampled), the 2-layer draft's round and
    a prefill chunk (greedy and sampled) through their CUDA graphs against
    the same runs eagerly, on a server with a ModelDraft and
    prefill_chunk=CHUNK: 7 slots filled, the 8th taking the chunks."""
    import torch
    from mxnet_tpu_torch.serve import ModelDraft

    name = "gpt %s" % (mode or "bf16")
    draft = ModelDraft(_draft_model(dev, SEED + 21))
    srv = _gen_server(model, dev, quantize=mode, draft=draft, spec_k=SPEC_K,
                      prefill_chunk=CHUNK)
    fill_slots(srv, prompts[:GPT_SLOTS - 1], [0.0] * (GPT_SLOTS - 1),
               GPT_NEW_TOKENS)
    srv._propose(srv._active_mask())
    c = srv.cache
    out = {}

    def verify(eager):
        logits = srv._run_verify(eager=eager).float().clone()
        return [logits, srv._emit.clone(), srv._tok.clone()]

    target_bufs = step_buffers(srv) + [srv._emit, srv._drafts]
    out["verify_greedy"] = program_against_eager(
        name + " verify greedy", srv._steps, verify, target_bufs, STEP_LN)[0]
    srv._temps[:] = [0.8 if i % 2 else 0.0 for i in range(GPT_SLOTS)]
    srv._ctl_dirty = True
    out["verify_sampled"] = program_against_eager(
        name + " verify sampled", srv._steps, verify, target_bufs,
        STEP_LN)[0]

    def draft_round(eager):
        logits = draft.propose(None, SPEC_K, eager=eager).float().clone()
        return [logits, srv._drafts.clone()]

    out["draft_round"] = program_against_eager(
        name + " draft round (2 layers)", draft._steps, draft_round,
        draft.cache.k + draft.cache.v + [srv._drafts], DRAFT_ROUND_LN)[0]

    slot = c.acquire("chunk probe")
    prompt = np.random.RandomState(SEED + 23).randint(
        0, GPT_CONFIG["vocab_size"], 700)
    srv._chunk_tokens.copy_(torch.from_numpy(
        prompt[None, CHUNK:2 * CHUNK].astype(np.int64)))
    srv._chunk_ctl.copy_(torch.tensor([slot, CHUNK, prompt.size, 5]))

    def chunk(sampling):
        def run(eager):
            logits = srv._run_chunk(sampling, eager=eager).float().clone()
            pages = c.k + c.v + (c.k_scale + c.v_scale if mode else [])
            return [logits, srv._tok.clone(), c.valid.clone()] + [
                t[slot].clone() for t in pages]
        return run

    for sampling in (False, True):
        srv._chunk_temp.fill_(0.8 if sampling else 0.0)
        out["chunk_%s" % ("sampled" if sampling else "greedy")] = \
            program_against_eager(
                "%s chunk %s (tokens %d-%d of %d)" % (
                    name, "sampled" if sampling else "greedy", CHUNK,
                    2 * CHUNK, prompt.size), srv._steps, chunk(sampling),
                step_buffers(srv), STEP_LN, n=3)[0]
    c.release(slot)
    out["keys"] = [list(map(str, k)) for k in srv._steps.keys()]
    srv.stop()
    del srv, draft
    torch.cuda.empty_cache()
    return out


def phase_speculative_breakdown(dev, n_prof=4):
    """Where a speculative round and a chunk tick spend their time, under
    torch.profiler, 8 slots live: a scheduler tick with NGramDraft (the
    host's proposals, the verify step, the readback and delivery), a
    2-layer ModelDraft round (its program and the drafts' readback), and a
    chunk tick of a chunked server (a chunk of 256 into the 8th slot, then
    the decode step of the 7 others, its readback); the host wall of each
    before the profiler."""
    import torch
    from mxnet_tpu_torch.serve import ModelDraft, NGramDraft

    model = _gpt_model(dev, SEED)
    prompts = [p for p, _, _ in _spec_requests(GPT_CONFIG["vocab_size"])]
    max_tokens = GPT_CONFIG["max_length"] - SPEC_K + 1
    out = {}

    def measure(what, srv, fn):
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            walls.append((time.perf_counter() - t0) * 1e3)
        r = _profile(fn, n_prof)
        r["host_wall_ms_median"] = float(np.median(walls))
        print("%s breakdown (torch.profiler, %d calls): kernel ms by class "
              "%s; %.1f kernels a call; %.3f ms busy in %.3f ms of wall: "
              "device idle %.1f%%; host wall before the profiler %.3f ms"
              % (what, n_prof, {k: round(v, 4) for k, v in
                                r["kernel_ms"].items()},
                 r["kernels_per_call"], r["busy_ms"], r["profiled_wall_ms"],
                 100 * r["device_idle_share"], r["host_wall_ms_median"]),
              flush=True)
        for ms, n, kname in r["top"][:8]:
            print("  %8.4f ms  x%-4d %s" % (ms, n, kname))
        check(r["busy_ms"] > 0, "the profiler saw no kernel time")
        return r

    srv = _gen_server(model, dev, draft=NGramDraft(), spec_k=SPEC_K)
    srv.warmup(max_tokens=max_tokens)
    fill_slots(srv, prompts[:GPT_SLOTS], [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
    out["ngram_round"] = measure("gpt bf16 NGramDraft round (a tick)", srv,
                                 srv.step)
    out["ngram_round"]["accept_rate"] = srv.stats()["accept_rate"]
    srv.stop()
    draft = ModelDraft(_draft_model(dev, SEED + 20))
    srv = _gen_server(model, dev, draft=draft, spec_k=SPEC_K)
    srv.warmup(max_tokens=max_tokens)
    fill_slots(srv, prompts[:GPT_SLOTS], [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
    out["draft_round"] = measure(
        "gpt bf16 ModelDraft(2 layers) round", srv,
        lambda: (srv._propose(srv._active_mask()), srv._drafts.cpu()))
    out["model_draft_tick"] = measure(
        "gpt bf16 ModelDraft(2 layers) tick (round, verify, delivery)", srv,
        srv.step)
    srv.stop()
    del srv, draft
    srv = _gen_server(model, dev, prefill_chunk=CHUNK)
    srv.warmup(max_tokens=GPT_CONFIG["max_length"])
    fill_slots(srv, prompts[:GPT_SLOTS - 1], [0.0] * (GPT_SLOTS - 1),
               GPT_NEW_TOKENS)
    slot = srv.cache.acquire("chunk probe")
    joiner = np.random.RandomState(SEED + 24).randint(
        0, GPT_CONFIG["vocab_size"], CHUNK_JOINER)
    srv._chunk_tokens.copy_(torch.from_numpy(
        joiner[None, CHUNK:2 * CHUNK].astype(np.int64)))
    srv._chunk_ctl.copy_(torch.tensor([slot, CHUNK, joiner.size, 0]))
    srv._chunk_temp.fill_(0.0)
    srv._ctl_dirty = True

    def chunk_tick():
        srv._run_chunk(False)
        srv._run_step()
        srv._tok.cpu()

    out["chunk_tick"] = measure("gpt bf16 chunk tick (a chunk of %d, then "
                                "the decode step of 7 slots)" % CHUNK, srv,
                                chunk_tick)
    srv.cache.release(slot)
    srv.stop()
    del srv
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------ quantized serving
# the quantized decode step with the kernels against the same step with the
# plain versions, elementwise on the logits (rms_ratio: atol + rtol |plain|
# + mtol rms). The step runs in fp32 after its first quantized Dense, so
# the LayerNorm kernel and its plain version differ by a few fp32 steps;
# where one of those flips an activation's rounding at .5, a quantized
# Dense's output moves by one step x_scale * w_scale * |w|, which reaches
# the logits diluted by the layers after it
QUANT_STEP_TOL = (1e-4, 2.0 ** -10, 2.0 ** -8)
# a whole int8 prefill or BERT forward with the kernels against the plain
# versions, each tensor in relative L2 norm. Each quantized Dense rounds
# its input to a step of the tensor's amax / 127, and a rounding that falls
# the other way at .5 moves a whole row, which attention spreads to the
# later rows and the next Dense layers to more roundings: from the second
# layer on the two runs differ by quantization noise throughout (printed;
# some percent on the card). So the limit grows with depth: the tensors
# before any quantized rounding can part (GPT's layer-0 K and V, BERT's
# embedding LayerNorm) within 2e-3, where a 1% gamma reads 1%; the next
# (GPT's layer-1 K and V, BERT's first cell), where the first roundings
# part, within 1e-2; every later tensor within 8e-2, about twice that
# noise, which a flash without its mask exceeds many times over
QUANT_REL_TOLS = (2e-3, 1e-2, 8e-2)
QUANT_FP8_BURST = ((20, 0, 0), (64, 0.8, 21), (130, 0, 0), (300, 0, 0))
QUANT_FP8_NEW = 16


def layernorm_eps_high(x, gamma, beta, eps):
    """A planted fault: the plain LayerNorm with eps 1e-3 for 1e-5."""
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    return ln.layernorm_plain(x, gamma, beta, 1e-3)


QUANT_FAULTS = {"LayerNorm gamma 1% high": {
                    "fused_layernorm": layernorm_gamma_high},
                "LayerNorm eps 1e-3": {"fused_layernorm": layernorm_eps_high}}


def graded_ratio(tensors):
    """Worst relative L2 error / limit over (name, got, ref, limit), and
    its name."""
    return max((float((a - b).norm() / b.norm()) / tol, name)
               for name, a, b, tol in tensors)


def quant_prefill_tensors(got, ref):
    """(name, got, ref, limit) of a prefill state's logits and every
    layer's K and V (QUANT_REL_TOLS by depth)."""
    first, second, deep = QUANT_REL_TOLS
    out = [("logits", got[0], ref[0], deep)]
    for i, ((k, v), (rk, rv)) in enumerate(zip(got[1], ref[1])):
        tol = first if i == 0 else second if i == 1 else deep
        out += [("layer %d K" % i, k, rk, tol), ("layer %d V" % i, v, rv,
                                                   tol)]
    return out


def phase_generate_quant(dev):
    """GPT-2 small with int8 weights and int8 KV pages through
    GenerativeServer(quantize="int8"): the two bursts of phase_generate
    (every counter at 0 just before them), exact LayerNorm launches, 12
    launches of the flash forward's fp32 form a prefill at a bucket of 256
    or more (the quantized q/k/v are fp32) and none of the bf16 one, one
    replay a decode step and no capture, the KV bytes at most 0.55x a bf16
    cache's; the quantized step and prefills at buckets 256, 512 and 1024
    with the kernels against the plain versions, planted faults above the
    limit; then e4m3 and e5m2 weights, one short burst each. Returns (the
    quantized model, the result)."""
    import torch
    from mxnet_tpu_torch.base import next_pow2
    from mxnet_tpu_torch.quantization import fp8_supported
    from mxnet_tpu_torch.serve import GenerativeServer

    t0 = time.perf_counter()
    model = _gpt_model(dev, SEED)
    srv = GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                           prefix_cache=True, timeout_ms=600000.0,
                           device=dev, quantize="int8")
    bursts = _gpt_requests(GPT_CONFIG["vocab_size"])
    srv.warmup(prompt_buckets=warm_prompts(bursts),
               max_tokens=GPT_CONFIG["max_length"])
    torch.cuda.synchronize()
    print("gpt2_small int8 (weights per channel, activations per tensor, "
          "KV pages int8): set-up and warmup %.2f s"
          % (time.perf_counter() - t0), flush=True)
    m0 = srv.stats()
    # the quantized main path, every counter at 0 just before it
    reset_counters()
    streams, timing = serve_bursts(srv, bursts, GPT_NEW_TOKENS, "gpt int8")
    torch.cuda.synchronize()
    launches = read_counters()
    stats = srv.stats()
    prefills = stats["prefills"] - m0["prefills"]
    steps = stats["decode_steps"] - m0["decode_steps"]
    hits = stats["prefix_hits"] - m0["prefix_hits"]
    captures = stats["step_captures"] - m0["step_captures"]
    replays = stats["step_replays"] - m0["step_replays"]
    seen = {p.tobytes(): len(p) for b in bursts for p, _, _ in b}
    at_256 = sum(next_pow2(n) >= 256 for n in seen.values())
    kv_ratio = srv.cache.nbytes() / srv.cache.nbytes_unquantized(itemsize=2)
    print("gpt int8 serving: %d prefills (%d at buckets >= 256), %d prefix "
          "hits, %d decode steps; kernel launches %s (flash fp32 form: %d "
          "at %d prefills of bucket >= 256, the quantized q/k/v are fp32); "
          "step programs %d captures, %d replays; "
          "step host wall p50 %s p99 %s ms; KV bytes %d = %.4f x bf16"
          % (prefills, at_256, hits, steps, launches,
             launches["flash_attention_fwd_f32"], at_256, captures, replays,
             stats["itl_p50_ms"], stats["itl_p99_ms"], srv.cache.nbytes(),
             kv_ratio), flush=True)
    check(stats["errors"] == 0 and stats["timeouts"] == 0,
          "int8 serving errors: %s" % stats)
    check(prefills == len(seen) and hits == sum(map(len, bursts)) - len(seen),
          "int8: prefills %d / hits %d" % (prefills, hits))
    for outs in streams:
        for s in outs:
            check(len(s) == GPT_NEW_TOKENS
                  and all(0 <= t < GPT_CONFIG["vocab_size"] for t in s),
                  "int8: a stream of %d tokens or a token out of range"
                  % len(s))
    want = {"layernorm": STEP_LN * (prefills + steps),
            "flash_attention_fwd_f32": GPT_CONFIG["num_layers"] * at_256}
    for k, n in launches.items():
        check(n == want.get(k, 0), "int8 serving: %s launches %d, expected "
              "%d" % (k, n, want.get(k, 0)))
    check(captures == 0 and replays == steps, "int8: %d captures and %d "
          "replays over %d decode steps" % (captures, replays, steps))
    check(at_256 > 0, "the int8 bursts hold no prompt of bucket >= 256")
    check(kv_ratio <= 0.55, "int8 KV pages take %.4f x the bf16 bytes"
          % kv_ratio)

    del srv

    # the quantized step with the kernels against the plain versions, on a
    # new server (a stopped one admits nothing) of the same model
    srv = GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                           prefix_cache=False, timeout_ms=600000.0,
                           device=dev, quantize="int8")
    rng = np.random.RandomState(SEED + 15)
    prompts = [rng.randint(0, GPT_CONFIG["vocab_size"], n).astype(np.int32)
               for n in GRAPH_PROMPTS]
    fill_slots(srv, prompts, [0.0] * GPT_SLOTS, GPT_NEW_TOKENS)
    saved = save_state(srv)

    def step_logits():
        logits = srv._run_step(eager=True).float().clone()
        restore_state(srv, saved)
        return logits

    got = step_logits()
    reset_counters()
    with plain_versions():
        ref = step_logits()
    check(not any(read_counters().values()),
          "the plain quantized step launched a kernel: %s" % read_counters())
    check(bool(torch.isfinite(got).all()), "non-finite int8 step logits")
    vs_plain = {"worst_ratio": rms_ratio(got, ref, QUANT_STEP_TOL),
                "max_abs_err": max_err(got, ref), "faults": {}}
    for name, override in QUANT_FAULTS.items():
        with plain_versions(**override):
            vs_plain["faults"][name] = rms_ratio(step_logits(), ref,
                                                 QUANT_STEP_TOL)
    print("gpt int8 decode step with kernels vs plain versions: max abs err "
          "%.4g, worst error/limit %.3f (limit %s); planted faults %s" % (
              vs_plain["max_abs_err"], vs_plain["worst_ratio"],
              QUANT_STEP_TOL, {k: round(v, 3) for k, v in
                               vs_plain["faults"].items()}), flush=True)
    check(vs_plain["worst_ratio"] <= 1.0, "the int8 step with the kernels "
          "disagrees with the plain versions")
    for name, r in vs_plain["faults"].items():
        check(r > 1.0, "the int8 step limit misses the planted fault %r"
              % name)
    srv.stop()
    del srv

    # int8 prefills at buckets 256, 512 and 1024 with the kernels (the
    # LayerNorm's fp32 rows, the flash forward's fp32 form) against the
    # plain versions, and planted faults against the limits
    # (QUANT_REL_TOLS)
    rng = np.random.RandomState(SEED + 22)
    prefills_vs_plain = []
    for length in GEN_PREFILL_LENS:
        prompt = rng.randint(0, GPT_CONFIG["vocab_size"],
                             length).astype(np.int32)
        tp = next_pow2(length)
        got = prefill_state(model, prompt, tp, dev)
        reset_counters()
        with plain_versions():
            ref = prefill_state(model, prompt, tp, dev)
        check(not any(read_counters().values()), "the plain int8 prefill "
              "launched a kernel: %s" % read_counters())
        check(bool(torch.isfinite(got[0]).all()),
              "non-finite int8 prefill logits")
        prefill = {"prompt": length, "bucket": tp,
                   "max_abs_err_logits": max_err(got[0], ref[0]),
                   "max_abs_err_kv": max(max_err(a, b) for x, y in
                                         zip(got[1], ref[1])
                                         for a, b in zip(x, y)),
                   "rel_l2": {n: float((a - b).norm() / b.norm()) for n, a, b, _
                              in quant_prefill_tensors(got, ref)},
                   "worst": graded_ratio(quant_prefill_tensors(got, ref)),
                   "faults": {}}
        for name, override in GEN_FAULTS.items():
            with plain_versions(**override):
                bad = prefill_state(model, prompt, tp, dev)
            prefill["faults"][name] = graded_ratio(
                quant_prefill_tensors(bad, ref))
        rel = prefill["rel_l2"]
        print("gpt int8 prefill (%d tokens, bucket %d) with kernels vs plain "
              "versions: max abs err logits %.4g, K/V %.4g; relative L2 "
              "layer 0 %.3g, layer 1 %.3g, layers 2-%d %.3g, logits %.3g; "
              "worst error/limit %.3f at %s (limits %s); planted faults %s"
              % (length, tp, prefill["max_abs_err_logits"],
                 prefill["max_abs_err_kv"],
                 max(v for k, v in rel.items() if k.startswith("layer 0 ")),
                 max(v for k, v in rel.items() if k.startswith("layer 1 ")),
                 GPT_CONFIG["num_layers"] - 1,
                 max([v for k, v in rel.items() if k.startswith("layer ")
                      and int(k.split()[1]) >= 2] or [0.0]),
                 rel["logits"], *prefill["worst"], QUANT_REL_TOLS,
                 {k: "%.3f at %s" % v for k, v in
                  prefill["faults"].items()}), flush=True)
        check(prefill["worst"][0] <= 1.0, "the int8 prefill at bucket %d "
              "with the kernels disagrees with the plain versions" % tp)
        for name, (r, _) in prefill["faults"].items():
            check(r > 1.0, "the int8 prefill limit at bucket %d misses the "
                  "planted fault %r" % (tp, name))
        prefills_vs_plain.append(prefill)

    fp8 = {}
    for mode in ("e4m3", "e5m2"):
        check(fp8_supported(mode), "fp8 %s is not supported here" % mode)
        m = _gpt_model(dev, SEED + 14)
        s = GenerativeServer(m, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                             timeout_ms=600000.0, device=dev, quantize=mode)
        burst = [(np.random.RandomState(SEED + 16 + i).randint(
            0, GPT_CONFIG["vocab_size"], n).astype(np.int32), t, sd)
            for i, (n, t, sd) in enumerate(QUANT_FP8_BURST)]
        s.warmup(prompt_buckets=warm_prompts([burst]),
                 max_tokens=max(n for n, _, _ in QUANT_FP8_BURST)
                 + QUANT_FP8_NEW)
        qdt = m.blocks[0].attn.qkv.qweight._tensor().dtype
        got, t = serve_bursts(s, [burst], QUANT_FP8_NEW, "gpt %s" % mode)
        st = s.stats()
        check(st["errors"] == 0 and all(
            len(x) == QUANT_FP8_NEW
            and all(0 <= v < GPT_CONFIG["vocab_size"] for v in x)
            for x in got[0]), "%s serving: %s" % (mode, st))
        fp8[mode] = {"weight_dtype": str(qdt), "burst": t[0],
                     "step_replays": st["step_replays"],
                     "decode_steps": st["decode_steps"]}
        print("gpt %s: weights %s" % (mode, qdt), flush=True)
        s.stop()
        del s, m
        torch.cuda.empty_cache()
    return model, {"mode": "int8", "bursts": timing, "prefills": prefills,
                   "prefix_hits": hits, "decode_steps": steps,
                   "launches": launches, "flash_prefills_at_256": at_256,
                   "step_programs": {"captures": captures,
                                     "replays": replays},
                   "kv_ratio_vs_bf16": kv_ratio,
                   "step_vs_plain": vs_plain,
                   "prefill_vs_plain": prefills_vs_plain,
                   "server_stats": stats,
                   "fp8": fp8}


# the quantized Dense layers' products: (rows, in, out) of GPT-2 small's
# decode step (8 slots) and a prefill at bucket 256, and of BERT-base's
# bucket-8 forward (its 4096 rows, the pooler's 8, the NSP head's 2 outputs)
LOWBIT_SHAPES = ((8, 768, 2304), (8, 768, 768), (8, 768, 3072),
                 (8, 3072, 768), (256, 768, 2304), (256, 3072, 768),
                 (4096, 768, 768), (4096, 768, 3072), (8, 768, 2))
# the limit of an fp8 product's error, in units of sum |term|: e5m2 goes
# through an fp32 matmul, held to the fp32 error bound of a sum of K terms
# in any order, K 2**-24 (None); e4m3 goes through the tensor cores'
# fp8 products, whose sums keep fewer bits than fp32 (the card reads up to
# 7.7e-5 at K = 768, 1.7x the fp32 bound): held to 2**-12, which a wrong
# operand, layout or scale still exceeds by orders of magnitude
LOWBIT_SUM_TOL = {"e4m3": 2.0 ** -12, "e5m2": None}


def phase_lowbit(dev):
    """F.quantized_fully_connected on the card against the dequantized
    product computed apart, in fp64 from the same quantized operands (exact:
    every partial sum of products of int8 or fp8 values fits fp64's 53
    bits): int8 bit for bit (the int32 sum exact, then the same fp32
    rescale and bias); e5m2 within the fp32 error bound of a sum of K
    terms in any order, K 2**-24 sum |term|; e4m3 within its
    ``LOWBIT_SUM_TOL``. Prints each fp8 mode's worst error in units of
    sum |term|."""
    import torch
    from mxnet_tpu_torch.ops import functional as F
    from mxnet_tpu_torch.ops.lowbit import (_dtype_qparams, _quantize_act,
                                            quantize_weight)

    g = torch.Generator(device=dev).manual_seed(SEED + 23)
    out = {}
    for mode in ("int8", "e4m3", "e5m2"):
        worst, worst_rel = 0.0, 0.0
        for M, K, N in LOWBIT_SHAPES:
            w = torch.randn(N, K, device=dev, generator=g) * 0.05
            x = torch.randn(M, K, device=dev, generator=g)
            bias = torch.randn(N, device=dev, generator=g)
            qw, ws = quantize_weight(w, axis=0, mode=mode)
            y = F.quantized_fully_connected(x, qw, ws, bias)
            qx, xs = _quantize_act(x, None, qw.dtype,
                                   *_dtype_qparams(qw.dtype))
            ref = qx.double() @ qw.double().t()
            what = "%s product (%d, %d) x (%d, %d)" % (mode, M, K, K, N)
            check(y.shape == (M, N) and y.dtype == torch.float32,
                  "%s: shape/dtype" % what)
            if mode == "int8":
                want = (ref.to(torch.int32).to(torch.float32)
                        * (xs * ws.reshape(-1)) + bias)
                check(torch.equal(y, want), "%s differs from the exact "
                      "integer product" % what)
                continue
            # y = acc * s + bias: the error of acc in units of the bound,
            # with the rescale's own rounding (one fp32 step of |acc s| and
            # of |y|) inside it
            s_ = (xs * ws.reshape(-1)).double()
            terms = (qx.double().abs() @ qw.double().abs().t()) * s_.abs()
            rounding = 2.0 ** -23 * ((ref * s_).abs() + y.double().abs())
            err = (y.double() - (ref * s_ + bias.double())).abs()
            tol = LOWBIT_SUM_TOL[mode] or K * 2.0 ** -24
            r = float((err / (tol * terms + rounding).clamp_min(1e-30)).max())
            worst = max(worst, r)
            worst_rel = max(worst_rel, float(
                ((err - rounding).clamp_min(0) / terms.clamp_min(1e-30))
                .max()))
            check(r <= 1.0, "%s: error %.3g of its limit" % (what, r))
        out[mode] = {"shapes": [list(t) for t in LOWBIT_SHAPES],
                     "worst_ratio": worst, "worst_of_sum_abs_terms":
                     worst_rel, "limit": LOWBIT_SUM_TOL.get(mode)}
        print("%s quantized_fully_connected at %d shapes: %s" % (
            mode, len(LOWBIT_SHAPES), "bit-equal to the exact integer product"
            if mode == "int8" else "worst error %.3g of sum |term| (%s), "
            "%.3g of the limit" % (worst_rel, "limit 2**-12"
                                   if LOWBIT_SUM_TOL[mode] else
                                   "limit K 2**-24", worst)), flush=True)
    return out


def flash_valid_len_dropped(q, k, v, **kw):
    """A planted fault: the plain flash attention over every key, the
    padding too."""
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    return fa.flash_attention_plain(q, k, v, **dict(kw, kv_valid_len=None))


BERT_QUANT_FAULTS = {"flash without the valid length": {
                         "flash_attention": flash_valid_len_dropped},
                     "LayerNorm gamma 1% high": {
                         "fused_layernorm": layernorm_gamma_high}}


def bert_layer_outputs(model, ins):
    """A BERT forward of ``ins``: [(name, fp32 tensor)] of the embedding
    LayerNorm's output, every encoder cell's and the model's outputs."""
    import torch

    seen = []

    def keep(name):
        return lambda mod, args, out: seen.append((name, out.float()))

    hooks = [model.encoder.ln.register_forward_hook(keep(
        "embedding LayerNorm"))]
    hooks += [cell.register_forward_hook(keep("cell %d" % i))
              for i, cell in enumerate(model.encoder.cells)]
    try:
        with torch.inference_mode():
            outs = model(*ins)
    finally:
        for h in hooks:
            h.remove()
    return seen + [("output %d" % i, o.float()) for i, o in enumerate(outs)]


def phase_serve_quant(dev):
    """BERT-base with int8 weights through ModelServer(buckets=(1, 4, 8),
    quantize="int8") at seq 512: the 16 requests of phase_serve in
    ``BERT_INT8_GROUPS``, each served batch equal to a direct quantized
    forward of the same rows, exact launches (25 LayerNorm and 12 of the
    flash forward's fp32 form a forward: the quantized q/k/v are fp32),
    each direct forward's first attention against the plain version on its
    own q/k/v; then a bucket-8 forward with the kernels against the plain
    versions, planted faults above the limit."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 20))
    amp.convert_hybrid_block(model, "bfloat16")
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    t0 = time.perf_counter()
    srv = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=1.0,
                      timeout_ms=120000.0, device=dev, quantize="int8")
    torch.cuda.synchronize()
    check_warm_graphs(srv.stats(), BUCKETS, "int8 BERT server")
    print("bert_base int8: set-up, quantization and warmup %.2f s"
          % (time.perf_counter() - t0), flush=True)
    tok, tt, vl = _bert_requests()
    groups = BERT_INT8_GROUPS
    with srv:
        b0 = srv.metrics.batches
        reset_counters()
        t0 = time.perf_counter()
        served = [srv.predict(tok[a:b], tt[a:b], vl[a:b]) for a, b in groups]
        wall = time.perf_counter() - t0
        launches = read_counters()
        forwards = srv.metrics.batches - b0
        stats = srv.stats()
    worst = 0.0
    # each direct forward's first attention (the flash forward's fp32 form
    # on the quantized q/k/v, at the served bucket and valid lengths) is
    # kept and then held against the plain version on the same inputs
    from mxnet_tpu_torch.ops import attention
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_plain)

    launch, first, attn_readings = attention.flash_attention, [], []

    def keep_first(q, k, v, **kw):
        out = launch(q, k, v, **kw)
        if not first:
            first.append((q, k, v, kw, out))
        return out

    attention.flash_attention = keep_first
    try:
        with torch.inference_mode():
            for (a, b), outs in zip(groups, served):
                ins = [torch.from_numpy(x[a:b]).to(dev)
                       for x in (tok, tt, vl)]
                first.clear()
                direct = [o.float().cpu().numpy() for o in model(*ins)]
                for o, d in zip(outs, direct):
                    check(np.isfinite(o).all(), "non-finite int8 BERT output")
                    worst = max(worst, float(np.abs(o.astype(np.float32)
                                                    - d).max()))
                q, k, v, kw, out = first[0]
                check(q.dtype == torch.float32, "int8 BERT attention is %s"
                      % q.dtype)
                attn_readings.append(held(
                    out, flash_attention_plain(q, k, v, **kw),
                    FLASH_F32_TOL, "bert int8 served forward %s: first "
                    "attention %s vl %s" % ((a, b), tuple(q.shape),
                                            kw["kv_valid_len"].tolist()),
                    flash_magnitude(q, k, v, kw["kv_valid_len"],
                                    kw["causal"], kw["scale"])))
    finally:
        attention.flash_attention = launch
    print("bert int8 served %d rows in %d forwards (%.1f ms); launches %s "
          "(flash: the fp32 form, the quantized q/k/v are fp32); served rows "
          "vs a direct "
          "quantized forward: max abs %.3g" % (N_REQUESTS, forwards,
                                               wall * 1e3, launches, worst),
          flush=True)
    check(stats["errors"] == 0 and forwards == len(groups),
          "int8 BERT serving: %d forwards, %s" % (forwards, stats))
    check(stats["captures"] == len(BUCKETS) and stats["drops"] == 0
          and stats["replays"] == len(BUCKETS) + forwards,
          "int8 BERT traffic captured a graph or ran without one: %s"
          % {k: stats[k] for k in GRAPH_KEYS})
    want = {"layernorm": 25 * forwards,
            "flash_attention_fwd_f32": 12 * forwards}
    check(all(n == want.get(k, 0) for k, n in launches.items()),
          "int8 BERT launches %s over %d forwards" % (launches, forwards))
    check(worst == 0.0, "int8 BERT served rows differ from a direct "
          "quantized forward")
    # a bucket-8 forward (the LayerNorm's fp32 (4096, 768) rows, the flash
    # forward's fp32 form at (8, 12, 512, 64)) with the kernels against the
    # plain versions: the embedding LayerNorm's output, every cell's and
    # the model's outputs (QUANT_REL_TOLS by depth)
    ins = [torch.from_numpy(x[5:13]).to(dev) for x in (tok, tt, vl)]
    got = bert_layer_outputs(model, ins)
    reset_counters()
    with plain_versions():
        ref = bert_layer_outputs(model, ins)
    check(not any(read_counters().values()),
          "the plain int8 BERT forward launched a kernel: %s"
          % read_counters())

    def graded(outs):
        first, second, deep = QUANT_REL_TOLS
        return [(n, a, b, first if n == "embedding LayerNorm" else second
                 if n == "cell 0" else deep)
                for (n, a), (_, b) in zip(outs, ref)]

    vs_plain = {"rel_l2": {n: float((a - b).norm() / b.norm())
                           for n, a, b, _ in graded(got)},
                "worst": graded_ratio(graded(got)),
                "max_abs_err": max(max_err(a, b) for (_, a), (_, b) in
                                   zip(got, ref)),
                "faults": {}}
    for name, override in BERT_QUANT_FAULTS.items():
        with plain_versions(**override):
            vs_plain["faults"][name] = graded_ratio(graded(
                bert_layer_outputs(model, ins)))
    rel = vs_plain["rel_l2"]
    print("bert int8 bucket-8 forward with kernels vs plain versions: max "
          "abs err %.4g; relative L2 embedding LayerNorm %.3g, cell 0 %.3g, "
          "later cells and outputs %.3g; worst error/limit %.3f at %s (limits "
          "%s); planted faults %s" % (
              vs_plain["max_abs_err"], rel["embedding LayerNorm"],
              rel["cell 0"], max(v for k, v in rel.items() if k not in (
                  "embedding LayerNorm", "cell 0")), *vs_plain["worst"],
              QUANT_REL_TOLS, {k: "%.3f at %s" % v for k, v in
                               vs_plain["faults"].items()}), flush=True)
    check(vs_plain["worst"][0] <= 1.0, "the int8 BERT forward with the "
          "kernels disagrees with the plain versions")
    for name, (r, _) in vs_plain["faults"].items():
        check(r > 1.0, "the int8 BERT limit misses the planted fault %r"
              % name)
    out = {"forwards": forwards, "wall_ms": wall * 1e3, "launches": launches,
           "served_vs_direct_max_abs": worst,
           "served_attention_vs_plain": attn_readings,
           "forward_vs_plain": vs_plain,
           "server_stats": stats}
    return out, (model, ins), srv


def phase_serve_quant_breakdown(model, ins, n_prof=4):
    """Where the int8 BERT bucket-8 forward at seq 512 (the served rows'
    valid lengths) spends its device time: kernel ms by class and kind
    from torch.profiler, the fp32 flash form under "flash"."""
    import torch

    def forward():
        with torch.inference_mode():
            model(*ins)

    forward()
    torch.cuda.synchronize()
    r = _profile(forward, n_prof)
    print("bert int8 bucket-8 forward breakdown (torch.profiler, %d calls): "
          "kernel ms by class %s, by kind %s; %.1f kernels a call; %.3f ms "
          "busy in %.3f ms of wall: device idle %.1f%%"
          % (n_prof, {k: round(v, 4) for k, v in r["kernel_ms"].items()},
             {k: round(v, 4) for k, v in r["kernel_ms_by_kind"].items()},
             r["kernels_per_call"], r["busy_ms"], r["profiled_wall_ms"],
             100 * r["device_idle_share"]), flush=True)
    for ms, n, kname in r["top"]:
        print("  %8.4f ms  x%-4d %s" % (ms, n, kname))
    check(r["busy_ms"] > 0, "the profiler saw no kernel time")
    return r


def _fine_class(name):
    """A decode step's kernels by kind: the classes of _kernel_class, with
    "other" split into reductions, elementwise passes, index and scatter
    kernels, copies and the sampler's top-k."""
    cls = _kernel_class(name)
    if cls != "other":
        return cls
    for key, fine in (("reduce", "reduce"), ("scatter", "index"),
                      ("gather", "index"), ("index", "index"),
                      ("elementwise", "elementwise"), ("Memcpy", "copy"),
                      ("Memset", "copy"), ("copy", "copy"),
                      ("topk", "topk"), ("sort", "topk"), ("radix", "topk")):
        if key in name:
            return fine
    return "other"


def phase_quant_timing(dev, records, quant):
    """The LayerNorm kernel on the quantized decode path, added to its
    record under ``generate_int8``: after the first quantized Dense the
    rows are fp32, so a decode step's (8, 768) fp32 rows (eps 1e-5), held
    to the plain version and timed against it, ``F.layer_norm`` and the
    bound; the launches are the int8 serving run's. Then the record of the
    flash forward's fp32 form, which only the quantized paths launch."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda.flash_attention import (
        _sms, f32_tile, flash_attention_f32, flash_attention_plain,
        flash_f32_splits)
    from mxnet_tpu_torch.ops.cuda.layernorm import (fused_layernorm,
                                                    layernorm_plain)

    g = torch.Generator(device=dev).manual_seed(SEED + 17)
    C = GPT_CONFIG["units"]
    x = torch.randn(GPT_SLOTS, C, device=dev, generator=g)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    reading = held(fused_layernorm(x, gamma, beta, 1e-5),
                   layernorm_plain(x, gamma, beta, 1e-5), FP32_TOL,
                   "gpt int8 path layernorm (%d, %d) fp32 eps 1e-05"
                   % (GPT_SLOTS, C))
    t = time_ms(lambda: fused_layernorm(x, gamma, beta, 1e-5),
                lambda: layernorm_plain(x, gamma, beta, 1e-5),
                lambda: TF.layer_norm(x, (C,), gamma, beta, 1e-5))
    t_ops, t_bytes = _ln_bound(GPT_SLOTS, C, 4)
    rec = {r["name"]: r for r in records}["layernorm_fwd"]
    rec["generate_int8"] = {
        "launches": quant["launches"]["layernorm"],
        "prefills": quant["prefills"], "decode_steps": quant["decode_steps"],
        "decode_step": dict(zip(("ms", "plain_ms", "library_ms"), t),
                            shape=[GPT_SLOTS, C], dtype="float32",
                            check=reading,
                            max_abs_err=reading["max_abs_err"],
                            bound_ms=max(t_ops, t_bytes) * 1e3,
                            bound_by="operations" if t_ops >= t_bytes
                            else "bytes")}
    r = rec["generate_int8"]["decode_step"]
    print("time gpt int8 path layernorm (%d, %d) fp32: kernel %.4f ms, plain "
          "%.4f ms, library %.4f ms, bound %.5f ms (%s)" % (
              GPT_SLOTS, C, r["ms"], r["plain_ms"], r["library_ms"],
              r["bound_ms"], r["bound_by"]), flush=True)

    # the flash forward's fp32 form: its record at the int8 BERT bucket-8
    # forward's shape with the served rows' valid lengths, and the int8 GPT
    # prefills' causal shapes beside it; the launches are the two int8
    # serving runs'
    H, D = GPT_CONFIG["num_heads"], C // GPT_CONFIG["num_heads"]
    B = BUCKETS[-1]
    vl = _bert_requests()[2][5:5 + B]
    q, k, v = _qkv(dev, g, B, H, SEQ, D, torch.float32)
    vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
    reading = held(flash_attention_f32(q, k, v, kv_valid_len=vlt),
                   flash_attention_plain(q, k, v, kv_valid_len=vlt),
                   FLASH_F32_TOL, "bert int8 flash fp32 %s vl %s"
                   % ((B, H, SEQ, D), [int(n) for n in vl]),
                   mag=flash_magnitude(q, k, v, vlt))
    mask = _sdpa_mask(vl, SEQ, dev)
    t = time_ms(lambda: flash_attention_f32(q, k, v, kv_valid_len=vlt),
                lambda: flash_attention_plain(q, k, v, kv_valid_len=vlt),
                lambda: TF.scaled_dot_product_attention(q, k, v,
                                                        attn_mask=mask))
    t_ops, t_bytes = _flash_fwd_f32_bound(B, H, SEQ, D, vl)
    bert = quant["bert_int8_serving"]
    n = quant["launches"]["flash_attention_fwd_f32"] \
        + bert["launches"]["flash_attention_fwd_f32"]
    calls = quant["flash_prefills_at_256"] + bert["forwards"]
    causal = []
    for T in (256, 512, 1024):
        q, k, v = _qkv(dev, g, 1, H, T, D, torch.float32)
        r = held(flash_attention_f32(q, k, v, causal=True),
                 flash_attention_plain(q, k, v, causal=True), FLASH_F32_TOL,
                 "gpt int8 flash fp32 causal (1, %d, %d, %d)" % (H, T, D),
                 mag=flash_magnitude(q, k, v, causal=True))
        tc = time_ms(lambda: flash_attention_f32(q, k, v, causal=True),
                     lambda: flash_attention_plain(q, k, v, causal=True),
                     lambda: TF.scaled_dot_product_attention(
                         q, k, v, is_causal=True))
        c_ops, c_bytes = _flash_fwd_f32_bound(1, H, T, D, None, causal=True)
        causal.append(dict(zip(("ms", "plain_ms", "library_ms"), tc),
                           shape=[1, H, T, D], check=r,
                           max_abs_err=r["max_abs_err"],
                           bound_ms=max(c_ops, c_bytes) * 1e3,
                           bound_by="operations" if c_ops >= c_bytes
                           else "bytes"))
    records.append(kernel_record(
        "flash_attention_fwd_f32",
        "mxnet_tpu_torch/csrc/flash_attention_fwd_f32.cu",
        "mxnet_tpu/ops/pallas/flash_attention.py:147", n, calls,
        reading["max_abs_err"], *t, t_ops, t_bytes,
        shape=[B, H, SEQ, D], dtype="float32", valid_len=[int(x) for x in vl],
        check=reading,
        main_path="the int8 GPT serving bursts' prefills at "
        "buckets >= 256 and the int8 BERT serving run's forwards",
        launches_gpt_int8=quant["launches"]["flash_attention_fwd_f32"],
        launches_bert_int8=bert["launches"]["flash_attention_fwd_f32"],
        causal_prefill=causal,
        library="scaled_dot_product_attention (fp32, boolean mask)"))
    for what, r in [("bert (%d, %d, %d, %d) vl" % (B, H, SEQ, D),
                     records[-1])] + [("gpt causal %s" % c["shape"], c)
                                      for c in causal]:
        print("time int8 path flash fp32 %-26s kernel %.4f ms, plain %.4f "
              "ms, library %.4f ms, bound %.5f ms (%s); (splits, key tiles "
              "a split) %s" % (
                  what, r["ms"], r["plain_ms"], r["library_ms"],
                  r["bound_ms"], r["bound_by"], flash_f32_splits(
                      r["shape"][0] * H, r["shape"][2], r["shape"][2],
                      what.startswith("gpt"), _sms(dev), D,
                      tile=f32_tile(D))), flush=True)


def _profile(fn, n):
    """Kernel ms by class a call of ``fn`` over ``n`` calls under
    torch.profiler (also by finer kind), the profiled wall a call, the
    device's idle share of it, and the top 15 kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    by_class = {"gemm": 0.0, "flash": 0.0, "layernorm": 0.0, "other": 0.0}
    by_kind, launches = {}, 0
    top = []
    for ev in prof.key_averages():
        # kernels only: a profiler range's device-side event is its span
        if ev.device_type != DeviceType.CUDA \
                or ev.key.startswith("mxnet_tpu_torch::"):
            continue
        ms = ev.self_device_time_total / 1e3 / n
        by_class[_kernel_class(ev.key)] += ms
        kind = _fine_class(ev.key)
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
        launches += ev.count
        top.append((ms, ev.count // n, ev.key[:90]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    return {"kernel_ms": by_class, "kernel_ms_by_kind": by_kind,
            "kernels_per_call": launches / n, "busy_ms": busy,
            "profiled_wall_ms": wall, "device_idle_share": 1.0 - busy / wall,
            "top": top[:15]}


def phase_generate_breakdown(dev, model, quantize=None, n_prof=4):
    """Where a 512-token prefill (bucket 512) and a decode step of 8 live
    slots spend their time, on a new server driven tick by tick: kernel ms
    by class, the profiled wall and the device's idle share; the decode
    step through its graph (a scheduler tick) and the same step run
    eagerly (with its readback); the decode step's host wall before the
    profiler."""
    import torch
    from mxnet_tpu_torch.serve import GenerativeServer
    from mxnet_tpu_torch.serve.decoder import GenerationStream

    what = "gpt %s" % (quantize or "bf16")
    srv = GenerativeServer(model, slots=GPT_SLOTS, top_k=GPT_TOP_K,
                           timeout_ms=600000.0, device=dev,
                           quantize=quantize)
    srv.cache.ensure_capacity(GPT_CONFIG["max_length"])
    rng = np.random.RandomState(SEED + 10)
    prompt = rng.randint(0, GPT_CONFIG["vocab_size"], 512).astype(np.int32)
    slot = srv.cache.acquire(GenerationStream(prompt, 1, 0.0, 0, 0))
    srv._prefill(slot, prompt, 0, 0.0)
    torch.cuda.synchronize()
    prefill = _profile(lambda: srv._prefill(slot, prompt, 0, 0.0), n_prof)
    srv.cache.release(slot)
    streams = [srv.submit(rng.randint(0, GPT_CONFIG["vocab_size"], 64),
                          max_new_tokens=GPT_NEW_TOKENS)
               for _ in range(GPT_SLOTS)]
    # the dispatcher thread hands each request to the join queue
    deadline = time.perf_counter() + 10.0
    while len(srv._join_q) < GPT_SLOTS and time.perf_counter() < deadline:
        time.sleep(0.001)
    srv.step()  # admits all eight (the loop thread is not running)
    check(srv.cache.num_active == GPT_SLOTS, "breakdown: %d slots live"
          % srv.cache.num_active)
    walls = []
    for _ in range(8):
        t0 = time.perf_counter()
        srv.step()
        walls.append((time.perf_counter() - t0) * 1e3)
    decode = _profile(srv.step, n_prof)
    decode["host_wall_ms_median"] = float(np.median(walls))
    eager = _profile(lambda: (srv._run_step(eager=True), srv._tok.cpu()),
                     n_prof)
    srv.stop()
    check(all(s.done() for s in streams), "breakdown streams left running")
    for name, r in (("prefill bucket 512", prefill),
                    ("decode step, 8 slots, graph", decode),
                    ("decode step, 8 slots, eager", eager)):
        print("%s %s breakdown (torch.profiler, %d calls): kernel ms by "
              "class %s, by kind %s; %.1f kernels a call; %.3f ms busy in "
              "%.3f ms of wall: device idle %.1f%%"
              % (what, name, n_prof, {k: round(v, 4) for k, v in
                                      r["kernel_ms"].items()},
                 {k: round(v, 4) for k, v in r["kernel_ms_by_kind"].items()},
                 r["kernels_per_call"], r["busy_ms"], r["profiled_wall_ms"],
                 100 * r["device_idle_share"]), flush=True)
        for ms, n, kname in r["top"]:
            print("  %8.4f ms  x%-4d %s" % (ms, n, kname))
        check(r["busy_ms"] > 0, "the profiler saw no kernel time")
    print("%s decode step host wall before the profiler: median %.3f ms of "
          "8" % (what, decode["host_wall_ms_median"]), flush=True)
    return {"prefill_bucket_512": prefill, "decode_step": decode,
            "decode_step_eager": eager}


# ----------------------------------------------------------- GPT training
# GPT-2 small (GPT_CONFIG, dropout 0.1) trained as a user of the JAX package
# writes it (tests/test_models.py test_gpt_training_descends, with
# gluon.loss.SoftmaxCrossEntropyLoss as mxnet_tpu/gluon/loss.py routes it),
# at bench.py's bert recipe: bf16 via amp, Adam lr 1e-4 wd 0.01 with fp32
# masters; batch 8 of 1025 random tokens, input the first 1024 and target
# the last 1024
GPT_TRAIN = {"batch": 8, "seq": 1024}
GPT_TRAIN_STEPS = 3
# kernel launches a step: 25 LayerNorms forward and backward (2 x 12
# layers and ln_f), 12 causal flash forwards with the lse and backwards,
# one softmax-xent over the (8192, 50257) logits each way
GPT_STEP_LAUNCHES = {"layernorm": 25, "layernorm_bwd": 25,
                     "flash_attention_fwd": 12, "flash_attention_bwd": 12,
                     "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
# the GPT step with the kernels against the same step with the plain
# versions: the loss (BERT's limit, STEP_LOSS_TOL), each gradient's
# relative L2, and the
# worst row's relative L2 of each gradient (a row: one output unit of a
# weight, one token's embedding), where a fault confined to a few vocabulary
# columns of the logits' gradient shows. Honest readings on an H100 (PERF.md
# section 2): loss 5e-6 to 5e-5, gradient 0.017 (the position embedding,
# bf16 through 12 layers and 1024 positions: BERT's 2e-2 would leave a
# margin of 1.2x, so 3e-2), worst row 0.115-0.162 (a qkv weight's row);
# planted faults (GPT_PLANTED_FAULTS): the first key tile dropped from the
# flash backward reads 0.535 and 3.6, each row's unaligned tail dropped from
# the softmax-xent dx 0.0156 and 0.875 (the last vocabulary rows of the
# tied embedding), so 0.3 for a row
GPT_STEP_GRAD_TOL = 3e-2
GPT_STEP_ROW_TOL = 0.3


class GPTTrainStep:
    """GPT-2 small language-model training through the port's entry points:
    ``GPTModel`` in bf16 via amp, next-token ``SoftmaxCrossEntropyLoss``
    over the (B, T, V) logits (the mean over T a sample),
    ``autograd.record`` / ``backward`` and ``gluon.Trainer`` (Adam unless
    another optimizer is given). Dropout draws from
    ``mxnet_tpu_torch.random``'s generator of the card
    (``random.seed`` restarts it)."""

    timed = TrainStep.timed

    def __init__(self, dev, optimizer="adam", optimizer_params=None):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.models.gpt import GPTModel

        self.model = GPTModel(dropout=0.1, **GPT_CONFIG)
        self.model.initialize(
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        amp.convert_hybrid_block(self.model, "bfloat16")
        self.params = list(self.model.collect_params().values())
        self.trainer = gluon.Trainer(
            self.model.collect_params(), optimizer, optimizer_params or {
                "learning_rate": 1e-4, "wd": 0.01, "multi_precision": True})
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
        seq = np.random.default_rng(SEED).integers(
            0, GPT_CONFIG["vocab_size"], (B, T + 1)).astype(np.int32)
        self.inp = torch.from_numpy(np.ascontiguousarray(seq[:, :T])).to(dev)
        self.tgt = torch.from_numpy(np.ascontiguousarray(seq[:, 1:])).to(dev)

    def __call__(self, update=True):
        """One step; returns the per-sample loss (B,)."""
        from mxnet_tpu_torch import autograd

        with autograd.record():
            loss = self.loss_fn(self.model(self.inp), self.tgt)
        autograd.backward(loss)
        if update:
            self.trainer.step(GPT_TRAIN["batch"])
        return loss.detach()


def grad_row_rel_l2(params, grads, ref_grads):
    """[(the worst row's |g - ref| / |ref| in L2, name)] of each parameter,
    worst first; a row is a slice along the first axis (a 1-D parameter is
    one row)."""
    rel = []
    for p, g, ref in zip(params, grads, ref_grads):
        g = g.float().reshape(g.shape[0], -1) if g.dim() > 1 \
            else g.float().reshape(1, -1)
        ref = ref.float().reshape(g.shape)
        num = (g - ref).norm(dim=1)
        den = ref.norm(dim=1)
        # an exact zero row of the reference must stay one
        r = num / den.clamp(min=1e-30) * (den > 0) + num * (den <= 0)
        rel.append((float(r.max()), p.name))
    return sorted(rel, reverse=True)


def flash_bwd_keys_dropped(q, k, v, do, lse, delta, drop, kv_valid_len=None,
                           scale=None, causal=False):
    """The plain backward with the (query, key) pairs where ``drop(rows,
    cols)`` is true left out of dq, dk and dv (a planted fault)."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    B, H, T, D = q.shape
    if scale is None:
        scale = 1.0 / D ** 0.5
    s, keep = fa._scores_plain(q, k, kv_valid_len, scale, causal)
    rows = torch.arange(T, device=q.device)[:, None]
    cols = torch.arange(k.shape[2], device=q.device)[None, :]
    keep = keep & ~drop(rows, cols)
    p = torch.where(keep, torch.exp(s - lse.reshape(B, H, T, 1)), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, H, T, 1))
    dq = torch.matmul(ds.to(k.dtype).float(), k.float()) * scale
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), do.float())
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2),
                      q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_first_key_tile_dropped(*args, **kw):
    """A planted fault: the first key tile (keys 0-63, which every causal
    query row sees) left out of dq, dk and dv."""
    return flash_bwd_keys_dropped(*args, drop=lambda r, c: c < 64, **kw)


def xent_dx_tail_dropped(x, labels, lse, dy):
    """A planted fault: the plain softmax-xent backward with each row's
    unaligned tail (the elements after its last whole 16-byte vector, as the
    kernel's ``split_row`` splits the row) left at 0."""
    import torch
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    dx = sx.softmax_xent_bwd_plain(x, labels, lse, dy)
    R, V = x.shape
    per = 16 // x.element_size()
    start = x.data_ptr() // x.element_size() + x.stride(0) * torch.arange(
        R, device=x.device, dtype=torch.int64)
    head = torch.clamp((-start) % per, max=V)
    body_end = head + (V - head) // per * per
    cols = torch.arange(V, device=x.device)
    return torch.where(cols[None, :] >= body_end[:, None],
                       torch.zeros((), dtype=dx.dtype, device=x.device), dx)


# faults planted into the plain-version GPT step, each the wrappers it
# replaces: the step's limits must catch every one, and must pass the plain
# step run again (no wrapper replaced)
GPT_PLANTED_FAULTS = {
    "flash bwd drops the first key tile": {
        "flash_attention_bwd": flash_bwd_first_key_tile_dropped},
    "softmax-xent dx drops each row's unaligned tail": {
        "softmax_xent_bwd": xent_dx_tail_dropped},
    "none (the plain step again)": {},
}


def phase_gpt_train(dev):
    """The GPT-2 small step: a few steps with finite losses that move the
    weights, exact launch counts a step, one step against the same step
    with the plain versions (and that plain step with planted faults), the
    step's wall, tokens/s and peak memory."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step = GPTTrainStep(dev)
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    n_params = sum(p._tensor().numel() for p in step.params)
    watch = [step.model.word_embed.weight, step.model.pos_embed.weight,
             step.model.ln_f.gamma, step.model.blocks[0].attn.qkv.weight]
    before = [p._tensor().detach().clone() for p in watch]
    torch.cuda.synchronize()
    print("gpt2 train step: %d parameters, batch %d, seq %d, vocab %d; "
          "set-up %.2f s" % (n_params, B, T, GPT_CONFIG["vocab_size"],
                             time.perf_counter() - t0), flush=True)

    # (a), (b): the main path, with every counter at 0 just before it
    mx_random.seed(SEED)
    reset_counters()
    losses = [float(step().mean()) for _ in range(GPT_TRAIN_STEPS)]
    launches = read_counters()
    print("gpt2 train losses %s; kernel launches in %d steps: %s"
          % (["%.4f" % x for x in losses], GPT_TRAIN_STEPS, launches),
          flush=True)
    check(all(np.isfinite(losses)), "non-finite gpt2 training loss")
    for p, b in zip(watch, before):
        check(not torch.equal(p._tensor(), b),
              "gpt2: %s did not move" % p.name)
    del before
    for name, n in GPT_STEP_LAUNCHES.items():
        check(launches[name] == n * GPT_TRAIN_STEPS,
              "gpt2 %s launches %d != %d x %d steps"
              % (name, launches[name], n, GPT_TRAIN_STEPS))
    check(launches["flash_attention_fwd_f32"] == 0,
          "gpt2 step launched the fp32 flash form")

    # (c): one step with the kernels and the same step with the plain
    # versions, from the same weights and the same dropout draws
    mx_random.seed(SEED)
    loss_k = step(update=False).float()
    grads_k = _grads(step.params)
    for p, gk in zip(step.params, grads_k):
        check(bool(torch.isfinite(gk).all()), "gpt2 %s: non-finite grad"
              % p.name)
    mx_random.seed(SEED)
    reset_counters()
    with plain_versions():
        loss_p = step(update=False).float()
    check(not any(read_counters().values()),
          "the plain-version gpt2 step launched a kernel: %s"
          % read_counters())
    grads_p = _grads(step.params)

    def reading(loss, grads):
        return {"loss_err": float((loss.mean() - loss_p.mean()).abs()),
                "worst_grad_rel_l2": [[r, n] for r, n in grad_rel_l2(
                    step.params, grads, grads_p)[:3]],
                "worst_row_rel_l2": [[r, n] for r, n in grad_row_rel_l2(
                    step.params, grads, grads_p)[:3]]}

    honest = reading(loss_k, grads_k)
    del grads_k
    print("gpt2 step with kernels vs plain versions: loss %.6f vs %.6f "
          "(|diff| %.3g, limit %g); worst gradient relative L2 %s (limit "
          "%g); worst row relative L2 %s (limit %g)"
          % (float(loss_k.mean()), float(loss_p.mean()), honest["loss_err"],
             STEP_LOSS_TOL, ["%.3g %s" % tuple(r)
                                 for r in honest["worst_grad_rel_l2"]],
             GPT_STEP_GRAD_TOL, ["%.3g %s" % tuple(r)
                                 for r in honest["worst_row_rel_l2"]],
             GPT_STEP_ROW_TOL), flush=True)

    def within(r):
        return (r["loss_err"] <= STEP_LOSS_TOL
                and r["worst_grad_rel_l2"][0][0] <= GPT_STEP_GRAD_TOL
                and r["worst_row_rel_l2"][0][0] <= GPT_STEP_ROW_TOL)

    check(within(honest), "gpt2 step disagrees with the plain versions: %s"
          % honest)
    faults = {}
    for name, override in GPT_PLANTED_FAULTS.items():
        mx_random.seed(SEED)
        with plain_versions(**override):
            loss_f = step(update=False).float()
        faults[name] = reading(loss_f, _grads(step.params))
        faults[name]["caught"] = not within(faults[name])
        print("gpt2 step, planted fault %r vs plain versions: loss |diff| "
              "%.3g, worst gradient relative L2 %s, worst row %s; caught %s"
              % (name, faults[name]["loss_err"],
                 ["%.3g %s" % tuple(r)
                  for r in faults[name]["worst_grad_rel_l2"]],
                 ["%.3g %s" % tuple(r)
                  for r in faults[name]["worst_row_rel_l2"]],
                 faults[name]["caught"]), flush=True)
        check(faults[name]["caught"] == bool(override),
              "the gpt2 step's limits %s %r" % (
                  "miss the planted fault" if override else "refuse", name))
    del grads_p

    # (d): the step's wall after warm-up, and its tokens/s
    step.timed(1)
    wall, timed_losses = step.timed(TIMED_STEPS)
    check(all(np.isfinite(timed_losses)), "non-finite gpt2 training loss")
    result = {"recipe": dict(GPT_TRAIN, config=GPT_CONFIG, dropout=0.1),
              "losses": losses + timed_losses, "launches": launches,
              "steps_counted": GPT_TRAIN_STEPS,
              "loss_vs_plain": [float(loss_k.mean()), float(loss_p.mean())],
              "vs_plain": honest, "planted_faults": faults,
              "step_wall_ms_median": wall,
              "tokens_per_s": B * T / wall * 1e3,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
    print("gpt2 train step: median host wall %.3f ms over %d steps, %.1f "
          "tokens/s; peak memory %.2f GB" % (
              wall, TIMED_STEPS, result["tokens_per_s"],
              result["peak_memory_gb"]), flush=True)
    return step, result


def phase_gpt_train_timing(dev, records, gpt_train):
    """The six kernels of the GPT step at its shapes, each held to its
    plain version and timed against it, its library call and its bound,
    added to their records under ``gpt_train`` with the step's launches:
    LayerNorm forward and backward at (8192, 768) eps 1e-5, the causal
    flash forward with the lse and the causal flash backward at
    (8, 12, 1024, 64), the softmax-xent forward and backward at
    (8192, 50257) bf16. A library backward is timed as forward + backward
    less the forward alone."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    rec = {r["name"]: r for r in records}
    launches, steps = gpt_train["launches"], gpt_train["steps_counted"]
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    C, V = GPT_CONFIG["units"], GPT_CONFIG["vocab_size"]
    H = GPT_CONFIG["num_heads"]
    D = C // H
    R = B * T

    def entry(name, times, bounds, shape, reading, **extra):
        t_ops, t_bytes = bounds
        out = dict(zip(("ms", "plain_ms", "library_ms"), times),
                   launches=launches[name],
                   launches_per_step=launches[name] / steps, shape=shape,
                   max_abs_err=reading["max_abs_err"], check=reading,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        out.update(extra)
        key = {"layernorm": "layernorm_fwd"}.get(name, name)
        rec[key]["gpt_train"] = out
        print("time gpt2 train %-20s at %s: kernel %.4f ms, plain %.4f ms, "
              "library %.4f ms, bound %.4f ms (%s), %g launches a step"
              % (key, shape, out["ms"], out["plain_ms"], out["library_ms"],
                 out["bound_ms"], out["bound_by"], out["launches_per_step"]),
              flush=True)

    # LayerNorm forward and backward at (8192, 768), eps 1e-5 (GPT-2's)
    x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    what = "gpt2 train layernorm (%d, %d) bf16" % (R, C)
    fwd = held(ln.fused_layernorm(x, gamma, beta, 1e-5),
               ln.layernorm_plain(x, gamma, beta, 1e-5), BF16_TOL, what)
    entry("layernorm", time_ms(
        lambda: ln.fused_layernorm(x, gamma, beta, 1e-5),
        lambda: ln.layernorm_plain(x, gamma, beta, 1e-5),
        lambda: TF.layer_norm(x, (C,), gb, bb, 1e-5)),
        _ln_bound(R, C, 2), [R, C], fwd, library="F.layer_norm, bf16 "
        "gamma and beta")
    dx, dgamma, dbeta = ln.fused_layernorm_bwd(x, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    ref = ln.layernorm_bwd_plain(x, gamma, dy, 1e-5)
    mags = layernorm_bwd_magnitudes(x, gamma, dy, 1e-5)
    bwd = {n: held(got, want, tol, what + " backward " + n, mag)
           for n, got, want, tol, mag in (
               ("dx", dx, ref[0], LN_BWD_DX_TOL["bfloat16"], mags[0]),
               ("dgamma", dgamma, ref[1], LN_BWD_PARAM_TOL, mags[1]),
               ("dbeta", dbeta, ref[2], LN_BWD_PARAM_TOL, mags[2]))}
    bwd["max_abs_err"] = max(r["max_abs_err"] for r in bwd.values())
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], gb, bb, 1e-5)
    entry("layernorm_bwd", time_ms(
        lambda: ln.fused_layernorm_bwd(x, gamma, dy, 1e-5),
        lambda: ln.layernorm_bwd_plain(x, gamma, dy, 1e-5),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [C], mean, rstd, gb, bb, [True, True, True])),
        _ln_bwd_bound(R, C, 2), [R, C], bwd,
        library="aten native_layer_norm_backward, bf16 gamma, the "
        "forward's mean and rstd given")
    del x, dy, dx, dgamma, dbeta, ref, mags, mean, rstd

    # the causal flash forward with the lse and the causal flash backward
    # at (8, 12, 1024, 64)
    q, k, v, do, lse, delta = flash_bwd_inputs(dev, g, B, H, T, D,
                                               causal=True)
    what = "gpt2 train flash causal %s" % ([B, H, T, D],)
    o_k, lse_k = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    o_p, lse_p = fa.flash_attention_plain(q, k, v, causal=True,
                                          return_lse=True)
    fwd = held(o_k, o_p, FLASH_TOL, what + " forward",
               flash_magnitude(q, k, v, causal=True))
    fwd["lse"] = held(lse_k, lse_p, (LSE_TOL, 0.0, 0.0), what + " lse")
    del o_k, lse_k, o_p, lse_p
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))

    def sdpa():
        return TF.scaled_dot_product_attention(qs, ks, vs, is_causal=True)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qs, ks, vs), do)

    t_fwd, t_fwd_plain, lib_fwd, lib_both = time_ms(
        lambda: fa.flash_attention(q, k, v, causal=True, return_lse=True),
        lambda: fa.flash_attention_plain(q, k, v, causal=True,
                                         return_lse=True),
        sdpa, sdpa_fwd_bwd)
    f_ops, f_bytes = _flash_causal_bound(B, H, T, D)
    entry("flash_attention_fwd", (t_fwd, t_fwd_plain, lib_fwd),
          (f_ops, f_bytes + 4 * B * H * T / PEAK_BYTES), [B, H, T, D], fwd,
          causal=True, return_lse=True,
          library="scaled_dot_product_attention(is_causal=True)")
    args = (q, k, v, do, lse, delta)
    dq, dk, dv = fa.flash_attention_bwd(*args, causal=True)
    torch.cuda.synchronize()
    rdq, rdk, rdv = fa.flash_attention_bwd_plain(*args, causal=True)
    mdq, mdk, mdv = flash_bwd_magnitudes(*args, causal=True)
    bwd = {"dq": held(dq, rdq, FLASH_BWD_TOL, what + " dq", mdq),
           "dk": held(dk, rdk, FLASH_BWD_TOL, what + " dk", mdk),
           "dv": held(dv, rdv, FLASH_BWD_TOL, what + " dv", mdv)}
    bwd["max_abs_err"] = max(r["max_abs_err"] for r in bwd.values())
    del dq, dk, dv, rdq, rdk, rdv, mdq, mdk, mdv
    t_bwd, t_bwd_plain = time_ms(
        lambda: fa.flash_attention_bwd(*args, causal=True),
        lambda: fa.flash_attention_bwd_plain(*args, causal=True))
    pairs = B * H * T * (T + 1) // 2 * D
    entry("flash_attention_bwd", (t_bwd, t_bwd_plain, lib_both - lib_fwd),
          (10 * pairs / PEAK_BF16,
           (7 * B * H * T * D * 2 + 2 * B * H * T * 4) / PEAK_BYTES),
          [B, H, T, D], bwd, causal=True,
          library="backward of scaled_dot_product_attention(is_causal="
          "True) (forward + backward less forward)")
    del q, k, v, do, lse, delta, args, qs, ks, vs

    # softmax-xent at the LM head: (8192, 50257) bf16 logits, dy = 1 / T
    # (the mean over T of SoftmaxCrossEntropyLoss, then the sum over B)
    x = (torch.randn(R, V, device=dev, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    labels[0] = V - 1
    dy = torch.full((R,), 1.0 / T, device=dev)
    what = "gpt2 train softmax-xent (%d, %d) bf16" % (R, V)
    loss, lse = sx.softmax_xent_fwd(x, labels)
    torch.cuda.synchronize()
    ref_loss, ref_lse = sx.softmax_xent_fwd_plain(x, labels)
    fwd = held(loss, ref_loss, XENT_TOL, what + " loss")
    fwd["lse"] = held(lse, ref_lse, XENT_TOL, what + " lse")
    dx = sx.softmax_xent_bwd(x, labels, ref_lse, dy)
    torch.cuda.synchronize()
    bwd = held(dx, sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy),
               XENT_DX_TOL["bfloat16"], what + " dx")
    del loss, lse, ref_loss, dx
    xf = x.float().requires_grad_()
    lab64 = labels.long()

    def lib_fwd_x():
        return TF.cross_entropy(xf, lab64, reduction="none")

    def lib_fwd_bwd_x():
        return torch.autograd.grad(lib_fwd_x(), xf, dy)

    ms, plain_ms, lib_ms, lib_both = time_ms(
        lambda: sx.softmax_xent_fwd(x, labels),
        lambda: sx.softmax_xent_fwd_plain(x, labels),
        lib_fwd_x, lib_fwd_bwd_x)
    ops = 5 * R * V
    xbytes = R * V * x.element_size()
    entry("softmax_xent_fwd", (ms, plain_ms, lib_ms),
          (ops / PEAK_FP32, (xbytes + 3 * R * 4) / PEAK_BYTES), [R, V], fwd,
          library="F.cross_entropy(reduction='none') on fp32 logits")
    bwd_ms, bwd_plain_ms = time_ms(
        lambda: sx.softmax_xent_bwd(x, labels, ref_lse, dy),
        lambda: sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy))
    entry("softmax_xent_bwd", (bwd_ms, bwd_plain_ms, lib_both - lib_ms),
          (ops / PEAK_FP32, (2 * xbytes + 3 * R * 4) / PEAK_BYTES), [R, V],
          bwd, library="backward of F.cross_entropy on fp32 logits "
          "(forward + backward less forward)")
    del x, xf, ref_lse
    torch.cuda.empty_cache()


# ------------------------------------------------------------ snapshots
def snapshot_expected_keys(manifest, spec_k):
    """The step programs a load must capture for a manifest's entries: each
    decode, verify and chunk entry's greedy and sampled programs (or those
    its ``sampling`` lists), at the snapshot's capacity."""
    keys = set()
    for fe in manifest["executables"].values():
        for s in fe.get("sampling", (False, True)):
            if fe["kind"] == "decode":
                keys.add(("decode", fe["capacity"], s))
            elif fe["kind"] == "verify":
                keys.add(("verify", fe["capacity"], spec_k, s))
            elif fe["kind"] == "chunk":
                keys.add(("chunk", fe["tp"], fe["capacity"], s))
    return keys


def first_token_ms(make, prompt):
    """``make()`` (a server) and one greedy request through it: (ms from
    the call to the server's return, ms to the request's first token, the
    server's step captures once the request is done)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv = make()
    torch.cuda.synchronize()
    built = (time.perf_counter() - t0) * 1e3
    with srv:
        stream = srv.submit(prompt, max_new_tokens=GPT_NEW_TOKENS)
        next(iter(stream))
        ms = (time.perf_counter() - t0) * 1e3
        stream.result(600)
    return built, ms, srv.stats()["step_captures"]


def phase_snapshot(dev):
    """Serving snapshots of GPT-2 small (``serve.snapshot``,
    ``serve.load(snapshot=True)``): a warmed bf16 server (prefix cache,
    ``prefill_chunk=256``, ``NGramDraft``) and a warmed int8 one, each
    serving burst 1 of ``phase_generate``, snapshotted, and loaded on a bare
    ``gpt2_small()`` skeleton: load captures exactly the listed programs, a
    request and the burst after it capture nothing, the parameters are
    bit-equal, the streams (the original's and the loaded one's) equal a
    plain server's of the same weights and mode (no prefix cache, draft or
    chunks; its logits recorded) under the tie-margin rule,
    ``GREEDY_TIE_TOL`` (bf16) or ``INT8_TIE_TOL`` (int8); a manifest with an
    edited
    fingerprint warns once and still serves. Prints the time from
    ``serve.load`` to the first token beside a cold replica's from the same
    artifact with no program listed, and a cold server's of the model
    already in memory (no warmup, its first request)."""
    import shutil
    import tempfile

    vocab = GPT_CONFIG["vocab_size"]
    burst, keys = [], set()
    for prompt, temp, seed in _gpt_requests(vocab)[0]:
        # the repeat (a prefix hit, greedy) gets a seed of its own: its
        # logits are recorded under its own key, its tokens are the same
        while _req_key(prompt, temp, seed) in keys:
            seed += 1
        keys.add(_req_key(prompt, temp, seed))
        burst.append((prompt, temp, seed))
    buckets = warm_prompts([burst])
    # the load's first request: the burst's first greedy one
    first = next(r for r in burst if not r[1])
    out = {}
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_work")
    os.makedirs(work, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="snapshots-", dir=work)
    try:
        for mode in (None, "int8"):
            out[mode or "bf16"] = snapshot_case(dev, mode, burst, buckets,
                                                first, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def snapshot_case(dev, mode, burst, buckets, first, tmp):
    """:func:`phase_snapshot` for one server (bf16 or int8)."""
    import warnings

    import torch
    from mxnet_tpu_torch import serve
    from mxnet_tpu_torch.cache import snapshot as snap
    from mxnet_tpu_torch.models.gpt import gpt2_small
    from mxnet_tpu_torch.serve import NGramDraft

    name = mode or "bf16"
    what = "gpt %s snapshot" % name
    model = _gpt_model(dev, SEED + 40)
    kw = {"quantize": mode, "prefix_cache": True}
    if mode is None:
        kw.update(prefill_chunk=CHUNK, draft=NGramDraft(), spec_k=SPEC_K)
    # the reference: a plain server of the same weights (no prefix cache,
    # no draft, no chunks), its logits recorded
    ref_srv = _gen_server(model, dev, quantize=mode)
    ref_srv.warmup(prompt_buckets=buckets,
                   max_tokens=GPT_CONFIG["max_length"])
    with record_logits(ref_srv) as rec:
        ref, _ = serve_bursts(ref_srv, [burst], GPT_NEW_TOKENS,
                              what + " reference (plain, logits recorded)")
    del ref_srv
    orig = _gen_server(model, dev, **kw)
    orig.warmup(prompt_buckets=buckets,
                max_tokens=GPT_CONFIG["max_length"] - SPEC_K + 1)
    got_orig, _ = serve_bursts(orig, [burst], GPT_NEW_TOKENS,
                               what + " original")
    tol = INT8_TIE_TOL if mode else GREEDY_TIE_TOL
    prefix = os.path.join(tmp, name)
    t0 = time.perf_counter()
    path = serve.snapshot(orig, prefix)
    save_ms = (time.perf_counter() - t0) * 1e3
    with open(path) as fh:
        manifest = json.load(fh)
    expected = snapshot_expected_keys(manifest, SPEC_K)
    # the entries load captures programs for; the eager ones are only kept
    captured = [k for k, fe in manifest["executables"].items()
                if fe["kind"] in ("decode", "verify", "chunk", "draftstep")]
    check(set(orig._steps.keys()) == expected,
          "%s: the manifest lists %s, the server holds %s"
          % (what, sorted(map(str, expected)),
             sorted(map(str, orig._steps.keys()))))
    draft = {"draft": NGramDraft()} if mode is None else {}

    def load(prefix=prefix, draft=draft):
        return serve.load(prefix, snapshot=True, model=gpt2_small(),
                          device=dev, timeout_ms=600000.0, **draft)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        srv = load()
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)]
    check(not warned, "%s: load warned %s" % (what, warned))
    st = srv.stats()
    check(set(srv._steps.keys()) == expected
          and st["step_captures"] == len(expected)
          and st["snapshot_programs"] == len(captured),
          "%s: load made %s (%d captures, %d programs), the manifest "
          "lists %s (%d entries)" % (
              what, sorted(map(str, srv._steps.keys())),
              st["step_captures"], st["snapshot_programs"],
              sorted(map(str, expected)), len(captured)))
    want_p = orig.model._collect_params_with_prefix()
    got_p = srv.model._collect_params_with_prefix()
    check(sorted(want_p) == sorted(got_p) and all(
        got_p[n]._tensor().dtype == p._tensor().dtype
        and torch.equal(got_p[n]._tensor(), p._tensor())
        for n, p in want_p.items()),
        "%s: the loaded parameters are not bit-equal" % what)
    # the load's first request, then the burst: nothing is captured
    captures0 = st["step_captures"]
    got, timing = serve_bursts(srv, [[first], burst], GPT_NEW_TOKENS,
                               what + " loaded")
    first_toks, got, timing = got[0][0], got[1:], timing[1:]
    st = srv.stats()
    check(st["step_captures"] == captures0 and st["errors"] == 0,
          "%s: %d programs captured in traffic after load, %d errors"
          % (what, st["step_captures"] - captures0, st["errors"]))
    vs_ref = compare_streams(burst, got[0], ref[0], rec.rows,
                             what + " loaded", tol=tol)
    orig_vs_ref = compare_streams(burst, got_orig[0], ref[0], rec.rows,
                                  what + " original", tol=tol)
    same = sum(a == b for a, b in zip(got[0], got_orig[0]))
    del srv
    torch.cuda.empty_cache()
    # the time from serve.load to the first token; a cold replica's from
    # the same artifact with no program listed (the checkpoint and config a
    # replica without a snapshot reads too, then its first request
    # captures what it needs); and a cold server's of the model already in
    # memory, from its construction (no warmup) to its first request's
    warm_built, warm_ms, warm_captures = first_token_ms(load, first[0])
    cold_prefix = prefix + "-cold"
    os.symlink(os.path.abspath(snap._params_path(prefix, 0)),
               snap._params_path(cold_prefix, 0))
    snap.atomic_write(snap._manifest_path(cold_prefix), json.dumps(
        dict(manifest, executables={})).encode())
    file_built, file_ms, file_captures = first_token_ms(
        lambda: load(cold_prefix), first[0])
    cold_built, cold_ms, cold_captures = first_token_ms(
        lambda: _gen_server(model, dev, **dict(
            kw, draft=NGramDraft() if mode is None else None)),
        first[0])
    torch.cuda.empty_cache()
    # a manifest with an edited fingerprint: one warning, and it serves
    manifest["fingerprint"] += "-edited"
    snap.atomic_write(path, json.dumps(manifest).encode())
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stale = load()
    warned = [str(w.message) for w in caught
              if issubclass(w.category, RuntimeWarning)]
    check(len(warned) == 1 and "was made by" in warned[0],
          "%s: an edited fingerprint gave the warnings %s"
          % (what, warned))
    with stale:
        stale_toks = stale.generate(first[0],
                                    max_new_tokens=GPT_NEW_TOKENS)
    first_row = ref[0][burst.index(first)]
    rows = rec.rows[_req_key(*first)]
    compare_to_plain(first_toks, first_row, rows, first,
                     what + " loaded, first request", tol)
    compare_to_plain(stale_toks, first_row, rows, first,
                     what + " loaded from the edited manifest", tol)
    del stale
    print("%s: %d programs listed (%d step programs), saved in %.1f ms, "
          "loaded in %.1f ms; serve.load to the first token %.1f ms (the "
          "load %.1f ms of it, %d captures in the request); a cold replica "
          "from the same artifact with no program listed %.1f ms (its load "
          "%.1f ms, %d captures in the request); a cold server of the model "
          "in memory %.1f ms (its construction %.1f ms, %d captures); %d of "
          "%d streams equal to the original's; against the reference %s"
          % (what, len(manifest["executables"]), len(expected), save_ms,
             load_ms, warm_ms, warm_built, warm_captures - len(expected),
             file_ms, file_built, file_captures, cold_ms, cold_built,
             cold_captures, same, len(burst),
             {k: v for k, v in vs_ref.items() if k != "margins"}),
          flush=True)
    return {
        "programs_listed": len(manifest["executables"]),
        "step_programs_captured_at_load": len(expected),
        "keys": sorted(manifest["executables"]),
        "save_ms": save_ms, "load_ms": load_ms,
        "load_to_first_token_ms": warm_ms, "load_of_it_ms": warm_built,
        "cold_first_token_ms": cold_ms, "cold_construction_ms": cold_built,
        "captures_in_first_request_after_load": warm_captures
        - len(expected),
        "cold_captures_in_first_request": cold_captures,
        "cold_from_artifact_first_token_ms": file_ms,
        "cold_from_artifact_load_ms": file_built,
        "cold_from_artifact_captures_in_first_request": file_captures,
        "loaded_vs_reference": vs_ref,
        "original_vs_reference": orig_vs_ref,
        "streams_equal_to_original": same, "streams": len(burst),
        "tokens_per_s": timing[0]["tokens_per_s"]}


# ---------------------------------------------------------------------------
# ModelServer: one CUDA graph per bucket, weight swap, bucket retune


GRAPH_KEYS = ("captures", "replays", "drops", "programs")
GRAPH_WALLS = 10      # host-wall samples of a bucket-8 dispatch, each way
GRAPH_REPLAYS = 20    # graph replays timed with CUDA events


def check_warm_graphs(stats, buckets, what):
    """Warmup made exactly one program (a CUDA graph on the card) a bucket,
    ran each once and dropped none."""
    check(stats["captures"] == len(buckets) and stats["drops"] == 0
          and stats["replays"] == len(buckets)
          and stats["programs"] == sorted(buckets),
          "%s warmup: %s, buckets %s" % (
              what, {k: stats[k] for k in GRAPH_KEYS}, list(buckets)))


def outputs_equal(a, b):
    """Two lists of numpy outputs, bitwise equal."""
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y)
        for x, y in zip(a, b))


def stale_replay(pool, ins):
    """A planted fault: the batch's bucket program run without the batch
    copied into its input buffers (they hold the last dispatch's)."""
    from mxnet_tpu_torch.serve.executor_pool import to_numpy

    n = len(ins[0])
    prog = pool._programs[pool.pick_bucket(n)]
    if prog.graph is None:
        outs = pool._forward(pool._params_fn(), prog.dev)
    else:
        prog.graph.replay()
        outs = prog.outs
    return [to_numpy(o)[:n] for o in outs]


def rebinding_swap(srv, path):
    """A planted fault: the swap's weights given to the parameters as new
    tensors (``set_data``) where the server copies them into the live
    ones."""
    from mxnet_tpu_torch.checkpoint import validate_swap

    picked = validate_swap(srv.model, path)
    params = srv.model._collect_params_with_prefix()
    with srv._params_lock:
        for name, arr in picked.items():
            params[name].set_data(arr.to(srv.device))
        srv._swap_epoch += 1


def bucket_device_ms(pool, bucket):
    """Device ms of one replay of the bucket's graph (CUDA events over
    ``GRAPH_REPLAYS`` replays), and the CUDA-event span of one eager
    forward of the same buffers (its launch gaps included)."""
    import torch

    prog = pool._programs[bucket]
    params = pool._params_fn()
    spans = []
    for run in (prog.graph.replay,
                lambda: pool._forward(params, prog.dev)):
        run()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(GRAPH_REPLAYS):
            run()
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end) / GRAPH_REPLAYS)
    return spans


def _bert_swap_files(dev, seed, quantize):
    """Another BERT-base's parameters (bf16 via amp, quantized like the
    served model) in a file under the build directory, and a file that
    lacks one of them; returns (good path, bad path)."""
    import tempfile

    import torch
    from mxnet_tpu_torch import amp, checkpoint
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.quantization import quantize_model

    other = bert_base(dropout=0.1, max_length=SEQ)
    other.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(seed))
    amp.convert_hybrid_block(other, "bfloat16")
    if quantize:
        quantize_model(other, mode=quantize)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    good = os.path.join(tmp, "bert_seed%d.params" % seed)
    other.save_parameters(good)
    arrays = {n: p._tensor() for n, p in
              other._collect_params_with_prefix().items()}
    arrays.pop(sorted(arrays)[0])
    bad = os.path.join(tmp, "bert_missing_one.params")
    checkpoint.save_arrays(bad, arrays)
    return good, bad


def swap_burst(srv, reqs, path):
    """The requests ``reqs`` one by one, a ``swap_parameters(path)`` from a
    second thread half way through. Returns every dispatch as (the swap
    epoch it ran under, its rows, its outputs), each request's result with
    whether it was submitted after the swap returned, and the errors."""
    run = srv._pool.run
    records = []

    def recording_run(ins, n_real=None, eager=False, traces=None):
        # called under the server's dispatch lock: the epoch read here is
        # the one the batch ran under
        outs = run(ins, n_real=n_real, eager=eager, traces=traces)
        records.append((srv._swap_epoch, [np.array(x) for x in ins], outs))
        return outs

    done = []
    swapper = threading.Thread(
        target=lambda: done.append(srv.swap_parameters(path)))
    srv._pool.run = recording_run
    try:
        # a half before the swap, a quarter while it runs, a quarter after
        # it returned
        handles = []
        for i, r in enumerate(reqs):
            if i == len(reqs) // 2:
                swapper.start()
            if i == 3 * len(reqs) // 4:
                swapper.join(timeout=300)
                check(not swapper.is_alive() and done,
                      "the swap did not return")
            handles.append((bool(done), srv.submit(*r)))
            time.sleep(0.002)
        results, errors = [], []
        for after, h in handles:
            try:
                results.append((after, h.result(timeout_s=300)))
            except Exception as e:  # every request must succeed
                errors.append(repr(e))
    finally:
        del srv._pool.run
    return records, results, errors


def phase_serve_graph(dev, srv, what, quantize=None):
    """One CUDA graph a ModelServer bucket (``srv``: phase_serve's bf16
    BERT-base server or phase_serve_quant's int8 one, after its traffic):
    each bucket's replay bitwise equal to an eager forward of the same
    padded batch (and a replay on stale input buffers caught), exact
    launches under replay, the host wall of a bucket-8 dispatch each way
    and its device time; a weight swap in a burst (no failed request, no
    capture, each batch bitwise the old or the new weights' eager forward,
    every request after the swap returned on the new weights; a swap that
    rebinds a parameter caught), a refused file, and ``retune_buckets()``
    on the measured histogram capturing exactly the new set."""
    import torch
    from mxnet_tpu_torch.checkpoint import SwapError

    pool = srv._pool
    tok, tt, vl = _bert_requests()
    flash = "flash_attention_fwd_f32" if quantize else "flash_attention_fwd"
    stats0 = srv.stats()
    check(stats0["captures"] == len(BUCKETS) and stats0["drops"] == 0,
          "%s: the graphs after traffic %s" % (
              what, {k: stats0[k] for k in GRAPH_KEYS}))
    # (a) each bucket's replay against an eager forward of the same padded
    # batch (the bucket partly filled: pad rows in), bitwise; exact launches
    batches = {b: [x[:max(1, b - 1)] for x in (tok, tt, vl)] for b in BUCKETS}
    reset_counters()
    with srv._params_lock:
        replayed = {b: pool.run(ins) for b, ins in batches.items()}
    launches = read_counters()
    with srv._params_lock:
        eager = {b: pool.run(ins, eager=True) for b, ins in batches.items()}
        # the planted fault: bucket 8 replayed on bucket 8's buffers as the
        # last dispatch left them (another batch), held to this one's
        other = [x[8:15] for x in (tok, tt, vl)]
        pool.run(other)
        stale = stale_replay(pool, batches[BUCKETS[-1]])
    equal = {b: outputs_equal(replayed[b], eager[b]) for b in BUCKETS}
    stale_caught = not outputs_equal(stale, eager[BUCKETS[-1]])
    print("%s: each bucket's graph replay vs an eager forward of the same "
          "padded batch, bitwise equal %s; planted fault (a replay on "
          "stale input buffers) caught %s; launches over the %d replays %s"
          % (what, equal, stale_caught, len(BUCKETS), launches), flush=True)
    check(all(equal.values()), "%s: a bucket's graph replay differs from "
          "its eager forward: %s" % (what, equal))
    check(stale_caught, "%s: the replay check misses a replay on stale "
          "input buffers" % what)
    want = {"layernorm": 25 * len(BUCKETS), flash: 12 * len(BUCKETS)}
    check(all(n == want.get(k, 0) for k, n in launches.items()),
          "%s: graph replay launches %s, want %s" % (what, launches, want))

    # (b) host wall of a bucket-8 dispatch, graph against eager, in turns;
    # the graph's device time
    b8 = [x[:8] for x in (tok, tt, vl)]
    walls = {"graph": [], "eager": []}
    for _ in range(GRAPH_WALLS):
        for mode in ("graph", "eager"):
            with srv._params_lock:
                t0 = time.perf_counter()
                pool.run(b8, eager=mode == "eager")
                walls[mode].append((time.perf_counter() - t0) * 1e3)
    with srv._params_lock:
        graph_ms, eager_span_ms = bucket_device_ms(pool, 8)
    timing = {"graph_dispatch_wall_ms_median": float(np.median(
                  walls["graph"])),
              "eager_dispatch_wall_ms_median": float(np.median(
                  walls["eager"])),
              "graph_replay_device_ms": graph_ms,
              "eager_forward_event_span_ms": eager_span_ms}
    timing["card"] = card_line()
    print("%s bucket-8 dispatch (pad, copy in, forward, copy out), medians "
          "of %d in turns: graph %.3f ms, eager %.3f ms of host wall; the "
          "graph's replay %.3f ms on the device, an eager forward's CUDA-"
          "event span %.3f ms; %s" % (what, GRAPH_WALLS, *timing.values()),
          flush=True)

    # (c) a weight swap in the middle of a burst
    good, bad = _bert_swap_files(dev, SEED + 40, quantize)
    old = os.path.join(os.path.dirname(good), "served.params")
    srv.model.save_parameters(old)
    epoch0 = srv.health()["swap_epoch"]
    before = srv.stats()
    reqs = [(tok[i], tt[i], vl[i]) for i in range(N_REQUESTS)]
    with srv:
        records, results, errors = swap_burst(srv, reqs, good)
    after = srv.stats()
    check(not errors and after["errors"] == before["errors"],
          "%s: requests failed across the swap: %s" % (what, errors))
    check(after["captures"] == before["captures"] and after["drops"] == 0,
          "%s: the swap made or dropped a graph: %s" % (
              what, {k: after[k] for k in GRAPH_KEYS}))
    epochs = sorted(set(e for e, _, _ in records))
    check(epochs in ([epoch0, epoch0 + 1], [epoch0 + 1]),
          "%s: dispatches ran under epochs %s" % (what, epochs))
    # each batch against an eager forward of its rows under the weights of
    # its epoch: the new ones now, the old ones after swapping them back
    mixed = []
    with srv._params_lock:
        for e, ins, outs in records:
            if e == epoch0 + 1 and not outputs_equal(
                    outs, pool.run(ins, eager=True)):
                mixed.append(("new", len(ins[0])))
    srv.swap_parameters(old)
    with srv._params_lock:
        for e, ins, outs in records:
            if e == epoch0 and not outputs_equal(
                    outs, pool.run(ins, eager=True)):
                mixed.append(("old", len(ins[0])))
    # every request submitted after the swap returned ran on the new weights
    by_row = {}
    for e, ins, outs in records:
        for i in range(len(ins[0])):
            by_row.setdefault(ins[0][i].tobytes(), set()).add(e)
    late = [r for (was_after, _), r in zip(results, reqs) if was_after]
    late_old = sum(1 for r in late if epoch0 in by_row[r[0].tobytes()])
    print("%s weight swap in a burst of %d requests: %d dispatches (%d on "
          "the old weights, %d on the new), %d failed requests, batches "
          "not bitwise one epoch's eager forward %s, %d of the %d requests "
          "after the swap returned on the old weights; graphs %s"
          % (what, len(reqs), len(records),
             sum(1 for e, _, _ in records if e == epoch0),
             sum(1 for e, _, _ in records if e == epoch0 + 1), len(errors),
             mixed, late_old, len(late),
             {k: after[k] for k in GRAPH_KEYS}), flush=True)
    check(not mixed, "%s: a batch is neither the old nor the new weights' "
          "forward: %s" % (what, mixed))
    check(late and late_old == 0, "%s: a request after the swap ran on the "
          "old weights (%d of %d)" % (what, late_old, len(late)))
    # a refused file keeps the weights: the next answer is the old one
    try:
        srv.swap_parameters(bad)
        refused = False
    except SwapError:
        refused = True
    one = [x[:1] for x in (tok, tt, vl)]
    with srv._params_lock:
        kept = outputs_equal(pool.run(one), pool.run(one, eager=True))
    check(refused and srv.health()["swap_epoch"] == epoch0 + 2 and kept,
          "%s: a bad file was not refused cleanly (refused %s, epoch %d)"
          % (what, refused, srv.health()["swap_epoch"]))
    # the planted fault: a swap that rebinds the parameters must show as a
    # capture (or a mismatch) at the next dispatch
    rebinding_swap(srv, good)
    with srv._params_lock:
        rebound = outputs_equal(pool.run(one), pool.run(one, eager=True))
    caught = srv.stats()["captures"] != after["captures"] or not rebound
    print("%s: a refused file keeps the old weights (%s); planted fault (a "
          "swap that rebinds the parameters) caught %s: graphs %s"
          % (what, refused and kept, caught,
             {k: srv.stats()[k] for k in GRAPH_KEYS}), flush=True)
    check(caught, "%s: the swap checks miss a rebinding swap" % what)

    # (d) retune to the measured request sizes: exactly the new set captured
    hist = srv.metrics.request_rows()
    srv.retune_buckets(max_buckets=2)
    tuned = srv.stats()
    print("%s retune_buckets(max_buckets=2) on the request-size histogram "
          "%s: buckets %s -> %s, graphs %s" % (
              what, hist, list(BUCKETS), list(srv.buckets),
              {k: tuned[k] for k in GRAPH_KEYS}), flush=True)
    check(srv.buckets != BUCKETS, "%s: the retune kept %s" % (what, BUCKETS))
    check_warm_graphs(tuned, srv.buckets, "%s retuned" % what)
    with srv._params_lock:
        retuned_equal = all(outputs_equal(
            srv._pool.run([x[:b] for x in (tok, tt, vl)]),
            srv._pool.run([x[:b] for x in (tok, tt, vl)], eager=True))
            for b in srv.buckets)
    check(retuned_equal and srv.stats()["captures"] == len(srv.buckets),
          "%s: a retuned bucket's replay differs from eager" % what)
    srv.stop()
    shutil.rmtree(os.path.dirname(good))
    torch.cuda.empty_cache()
    return {"replay_vs_eager_bitwise": equal,
            "stale_buffers_fault_caught": stale_caught,
            "launches_over_replays": launches, "timing": timing,
            "swap": {"dispatches": len(records), "failed": len(errors),
                     "mixed": mixed, "late_on_old": late_old,
                     "rebinding_fault_caught": caught,
                     "bad_file_refused": refused},
            "retune": {"histogram": {str(k): v for k, v in hist.items()},
                       "buckets": list(srv.buckets),
                       "graphs": {k: tuned[k] for k in GRAPH_KEYS}}}


# ---------------------------------------------------------------------------
# C.5 on the card: ids outside the table beside a good stream

BAD_ID_NEW_TOKENS = 16


def phase_bad_ids(dev, model):
    """GPT-2 small (bf16, graphed decode) serves a prompt with the id
    vocab + 43 and one with -1 beside a good stream: no device assert, no
    error, the good stream equal to its solo run, the first bad stream all
    token 0 (its NaN logits' argmax, as on the CPU and in the JAX
    package) and the -1 stream equal to the same prompt with vocab - 1 in
    its place."""
    import torch

    V = GPT_CONFIG["vocab_size"]
    rng = np.random.RandomState(SEED + 30)
    good = rng.randint(0, V, 40).astype(np.int32)
    past = rng.randint(0, V, 24).astype(np.int32)
    past[7] = V + 43
    neg = rng.randint(0, V, 24).astype(np.int32)
    neg[5] = -1
    wrapped = neg.copy()
    wrapped[5] = V - 1
    srv = _gen_server(model, dev)
    srv.warmup(prompt_buckets=(32, 64), max_tokens=64 + BAD_ID_NEW_TOKENS)
    n = BAD_ID_NEW_TOKENS
    with srv:
        solo = srv.submit(good, max_new_tokens=n).result(600)
        solo_wrapped = srv.submit(wrapped, max_new_tokens=n).result(600)
        handles = [srv.submit(p, max_new_tokens=n) for p in (good, past, neg)]
        got = [h.result(600) for h in handles]
        stats = srv.stats()
    torch.cuda.synchronize()  # a device assert would raise here
    out = {"good_equals_solo": got[0] == solo,
           "past_end_tokens": got[1],
           "negative_equals_wrapped": got[2] == solo_wrapped,
           "errors": stats["errors"]}
    print("C.5 on the card: a stream with id %d and one with -1 beside a "
          "good one: errors %d; good stream equal to its solo run %s; the "
          "past-the-end stream %s; the -1 stream equal to the prompt with "
          "%d %s" % (V + 43, stats["errors"], out["good_equals_solo"],
                     got[1], V - 1, out["negative_equals_wrapped"]),
          flush=True)
    check(stats["errors"] == 0, "bad ids: %d errors" % stats["errors"])
    check(out["good_equals_solo"], "bad ids: the good stream changed")
    check(got[1] == [0] * n, "bad ids: the past-the-end stream gave %s"
          % got[1])
    check(out["negative_equals_wrapped"], "bad ids: the -1 stream is not "
          "the wrapped prompt's")
    srv.stop()
    del srv
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The optimizers on GPT-2 small's parameters

# each optimizer with settings that reach its every branch (the parity
# tests use the same table)
OPTIMIZER_KW = {
    "sgd": dict(momentum=0.9, learning_rate=0.1),
    "nag": dict(momentum=0.9, learning_rate=0.1),
    "adam": dict(learning_rate=0.01),
    "adamw": dict(learning_rate=0.01),
    "adagrad": dict(learning_rate=0.1),
    "adadelta": dict(),
    "rmsprop": dict(learning_rate=0.01, centered=True),
    "ftrl": dict(learning_rate=0.1, lamda1=0.01),
    "lamb": dict(learning_rate=0.01, lower_bound=0.1, upper_bound=10.0),
    "signum": dict(learning_rate=0.01, wd_lh=0.01),
    "adamax": dict(learning_rate=0.01),
    "ftml": dict(learning_rate=0.01),
    "dcasgd": dict(learning_rate=0.1, momentum=0.9),
    "lars": dict(learning_rate=0.1, momentum=0.9, eta=0.01),
    "sgld": dict(learning_rate=0.01),
}
# one Trainer.step on the card (bf16 weights, fp32 masters) against the same
# port code on the CPU in fp32 from the same fp32 values: per tensor,
# max |card update - CPU update| / max |CPU update|. The two run the same
# fp32 ops; CUDA's kernels contract and divide in other ways, and LAMB's
# and LARS's norms sum in another order
OPTIM_STEP_TOL = 1e-4
OPTIM_GRAD_SCALE = 1e-2
# the parameters held against the CPU (all of them step on the card): the
# embeddings (the tied head), ln_f, and the first and the last block
OPTIM_CPU_PREFIXES = ("word_embed", "pos_embed", "ln_f", "blocks.0.",
                      "blocks.11.")


class sgld_noise_off:
    """Within the block, SGLD draws its noise as zeros."""

    def __enter__(self):
        from mxnet_tpu_torch import optimizer as topt

        self._noise = topt.SGLD._noise
        topt.SGLD._noise = lambda opt, w: w.new_zeros(w.shape)
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch import optimizer as topt

        topt.SGLD._noise = self._noise


class lamb_without_trust_ratio:
    """A planted fault: within the block, every trust ratio is 1 (LAMB
    steps as AdamW)."""

    def __enter__(self):
        import torch
        from mxnet_tpu_torch import optimizer as topt

        self._scales = topt._trust_scales
        topt._trust_scales = lambda wn, on, lrs, *a, **kw: list(torch.tensor(
            lrs, dtype=torch.float32, device=wn[0].device).unbind())
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch import optimizer as topt

        topt._trust_scales = self._scales


def _update_error(card, ref, start):
    """max |card update - reference update| / max |reference update|."""
    d_ref = ref - start
    return float((card - start - d_ref).abs().max()
                 / d_ref.abs().max().clamp(min=1e-30))


def phase_optimizers(dev):
    """One ``Trainer.step`` of each of the fifteen optimizers over GPT-2
    small's parameters (bf16 weights, fp32 masters) from the same seeded
    gradients, each held against the port's same step on the CPU in fp32
    (``OPTIM_CPU_PREFIXES``' tensors, ``OPTIM_STEP_TOL``), SGLD with its
    noise as zeros and then its noise's moments; a LAMB reference without
    its trust ratio (a planted fault) above the limit; each step's span on
    the card (CUDA events)."""
    import torch
    from mxnet_tpu_torch import amp, gluon
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.models.gpt import GPTModel

    model = GPTModel(dropout=0.0, **GPT_CONFIG)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 50))
    amp.convert_hybrid_block(model, "bfloat16")
    # the Trainer's order (its state indices), with the structural names
    struct = {id(p): n for n, p in model._collect_params_with_prefix().items()}
    params = list(model.collect_params().values())
    named = [(struct[id(p)], p) for p in params]
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    start = [p._tensor().detach().clone() for p in params]
    grads = [(torch.randn(p.shape, device=dev, generator=gen)
              * OPTIM_GRAD_SCALE).to(p.dtype) for p in params]
    held_idx = [i for i, (n, _) in enumerate(named)
                if n.startswith(OPTIM_CPU_PREFIXES)]
    start_cpu = [start[i].float().cpu() for i in held_idx]
    grads_cpu = [grads[i].float().cpu() for i in held_idx]
    n_params = sum(p._tensor().numel() for p in params)
    n_held = sum(t.numel() for t in start_cpu)
    print("optimizers on gpt2 small: %d tensors, %d parameters (bf16, fp32 "
          "masters); %d tensors, %d parameters held against the CPU"
          % (len(params), n_params, len(held_idx), n_held), flush=True)

    def card_step(name, noise=False):
        """One Trainer.step from ``start``; returns the fp32 weights (the
        masters) of the held tensors, on the CPU, and the CUDA-event span
        of a second step (host launches included)."""
        with torch.no_grad():
            for p, w, g in zip(params, start, grads):
                p._tensor().copy_(w)
                p._tensor().grad = g.clone()
        tr = gluon.Trainer(model.collect_params(), name, dict(
            OPTIMIZER_KW[name], wd=0.01, multi_precision=True))
        check(len(tr._params) == len(params), "a GPT-2 parameter is frozen")
        if noise:
            tr.step(1)
        else:
            with sgld_noise_off():
                tr.step(1)
        out = []
        for i in held_idx:
            s = tr._states[i]
            w = s["master"] if isinstance(s, dict) else params[i]._tensor()
            out.append(w.detach().to("cpu", torch.float32, copy=True))
        # a second step, its states made: the span of a steady step
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        tr.step(1)
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1])

    def cpu_step(name):
        opt = topt.create(name, **dict(OPTIMIZER_KW[name], wd=0.01))
        ws = [w.clone() for w in start_cpu]
        states = [opt.create_state(i, w) for i, w in enumerate(ws)]
        with sgld_noise_off():
            opt.fused_update(ws, grads_cpu, states)
        return ws

    results = {}
    for name in sorted(OPTIMIZER_KW):
        card, span = card_step(name)
        ref = cpu_step(name)
        errs = [_update_error(c, r, s)
                for c, r, s in zip(card, ref, start_cpu)]
        worst = max(range(len(errs)), key=errs.__getitem__)
        results[name] = {"worst_update_error": errs[worst],
                         "worst_tensor": named[held_idx[worst]][0],
                         "step_event_span_ms": span}
        if name == "lamb":
            with lamb_without_trust_ratio():
                planted = cpu_step(name)
            results[name]["planted_no_trust_ratio"] = max(
                _update_error(c, r, s)
                for c, r, s in zip(card, planted, start_cpu))
        if name == "sgld":
            noisy, _ = card_step(name, noise=True)
            noise = torch.cat([(a - b).reshape(-1)
                               for a, b in zip(noisy, card)])
            lr = OPTIMIZER_KW["sgld"]["learning_rate"]
            results[name]["noise_mean"] = float(noise.mean())
            results[name]["noise_std_over_sqrt_lr"] = float(
                noise.std() / lr ** 0.5)
        del card, ref
        print("optimizer %-8s one step over gpt2 small: card vs CPU worst "
              "update error %.3g (%s, limit %g); step span on the card "
              "%.3f ms%s" % (
                  name, errs[worst], results[name]["worst_tensor"],
                  OPTIM_STEP_TOL, span,
                  "; planted fault (no trust ratio) reads %.3g"
                  % results[name]["planted_no_trust_ratio"]
                  if name == "lamb" else "; noise mean %.3g, std/sqrt(lr) "
                  "%.4f" % (results[name]["noise_mean"],
                            results[name]["noise_std_over_sqrt_lr"])
                  if name == "sgld" else ""), flush=True)
    for name, r in results.items():
        check(r["worst_update_error"] <= OPTIM_STEP_TOL,
              "optimizer %s on the card disagrees with the CPU: %s"
              % (name, r))
    check(results["lamb"]["planted_no_trust_ratio"] > OPTIM_STEP_TOL,
          "the optimizer limit misses a LAMB step without its trust ratio")
    check(abs(results["sgld"]["noise_mean"]) < 5 * (
        OPTIMIZER_KW["sgld"]["learning_rate"] / n_held) ** 0.5
        and abs(results["sgld"]["noise_std_over_sqrt_lr"] - 1) < 0.01,
        "SGLD's noise on the card is not N(0, lr): %s" % results["sgld"])
    del model, params, start, grads
    torch.cuda.empty_cache()
    return results


GPT_OPTIM_RUNS = {
    "sgd_cosine": ("sgd", {"momentum": 0.9, "wd": 0.01}),
    "lamb": ("lamb", {"learning_rate": 1e-3, "wd": 0.01}),
}
GPT_COSINE = dict(max_update=20, base_lr=0.05, warmup_steps=2,
                  warmup_begin_lr=0.005)


def phase_gpt_train_optimizers(dev):
    """Three GPT-2 small training steps (``phase_gpt_train``'s recipe) with
    SGD (momentum 0.9) under a CosineScheduler with warmup, and three with
    LAMB: finite losses, weights that move, each step's learning rate the
    scheduler's, exact launches; then the step's host wall. Returns the
    two steps (for the profiler breakdown) and the readings."""
    import torch
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.lr_scheduler import CosineScheduler

    steps, out = {}, {}
    for label, (name, kw) in GPT_OPTIM_RUNS.items():
        kw = dict(kw, multi_precision=True)
        sched = None
        if label == "sgd_cosine":
            sched = CosineScheduler(**GPT_COSINE)
            kw["lr_scheduler"] = CosineScheduler(**GPT_COSINE)
        step = GPTTrainStep(dev, name, kw)
        watch = [step.model.word_embed.weight, step.model.ln_f.gamma,
                 step.model.blocks[0].attn.qkv.weight]
        before = [p._tensor().detach().clone() for p in watch]
        mx_random.seed(SEED)
        reset_counters()
        losses, rates = [], []
        for _ in range(GPT_TRAIN_STEPS):
            rate = step.trainer.learning_rate
            n = step.trainer.optimizer.num_update
            rates.append(rate)
            if sched is not None:
                check(rate == sched(n), "gpt2 %s: learning rate %r at "
                      "update %d, the scheduler says %r"
                      % (label, rate, n, sched(n)))
            losses.append(float(step().mean()))
        launches = read_counters()
        check(all(np.isfinite(losses)), "gpt2 %s: non-finite loss" % label)
        for p, b in zip(watch, before):
            check(not torch.equal(p._tensor(), b), "gpt2 %s: %s did not move"
                  % (label, p.name))
        for k, v in GPT_STEP_LAUNCHES.items():
            check(launches[k] == v * GPT_TRAIN_STEPS,
                  "gpt2 %s %s launches %d != %d x %d steps"
                  % (label, k, launches[k], v, GPT_TRAIN_STEPS))
        wall, timed = step.timed(GPT_TRAIN_STEPS)
        check(all(np.isfinite(timed)), "gpt2 %s: non-finite loss" % label)
        out[label] = {"losses": losses + timed, "learning_rates": rates,
                      "launches": launches, "step_wall_ms_median": wall}
        print("gpt2 train %s: losses %s, learning rates %s, launches %s; "
              "median host wall %.3f ms a step" % (
                  label, ["%.4f" % x for x in losses + timed],
                  ["%.5g" % r for r in rates], launches, wall), flush=True)
        steps[label] = step
        del before
    return steps, out


# ------------------------------------------------------------ vision
# bench.py's resnet50 mode: ResNet-50 v1, 1000 classes, batch 128 of
# 224x224 images (fp32, cast to bf16 at entry), amp bf16 with fp32 masters,
# SGD lr 0.1 momentum 0.9 wd 1e-4
RESNET = {"batch": 128, "size": 224, "classes": 1000}
RESNET_SGD = {"learning_rate": 0.1, "momentum": 0.9, "multi_precision": True,
              "wd": 1e-4}
RESNET_STEPS = 10      # the main path: steps on one fixed batch
RESNET_TIMED = 10
# kernel launches a step: the one softmax-xent over the (128, 1000) logits
# each way, and no other kernel of the port
RESNET_STEP_LAUNCHES = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
# yardsticks, not targets: bench.py's cost count (23.52 GFLOP an image of
# training, so 3.01 TFLOP a step of 128) and BASELINE.md's A100 rate
RESNET_FLOP_PER_IMAGE = 23.52e9
RESNET_A100_IMG_S = 2900.0
# the step with the kernels against the same step with the plain versions:
# only the loss's backward differs (the softmax-xent kernels against their
# plain fp32 arithmetic, a few fp32 steps apart), then bf16 through 50
# layers and cuDNN's algorithms, some of whose weight gradients add in no
# fixed order: the loss (as BERT's and GPT-2's), each gradient's relative
# L2 and its worst row's (GPT-2's limits), each moving statistic's relative
# L2 (the forward does not reach the loss kernels: it differs only by
# such an order). A conv bias before a training BatchNorm has no gradient
# but rounding's: not held.
RESNET_LOSS_TOL = 1e-2
RESNET_GRAD_TOL = 2e-2
RESNET_ROW_TOL = 0.3
RESNET_STAT_TOL = 1e-3
# the bf16 step against the fp32 step (TF32 off) from the same bf16-rounded
# weights. At bench.py's random start ResNet-50 v1 is chaotic: at batch 2-8
# on the CPU the bf16 and fp32 gradients are unrelated (relative L2 about
# 1.2, the loss apart by 4%), as a 1e-6 change of the input moves the fp32
# gradients by a few percent. From the zero-init residual start (each
# residual body's last BatchNorm gamma at 0: every block its shortcut, the
# gradients moved 3e-6 by the same change) the comparison means something:
# on the CPU at batch 4-8 bf16 moves each gradient by 0.09-0.20 and the
# whole by 0.08-0.16 in relative L2 (bf16 activations and cotangents
# through BatchNorm's backward, whose subtracted means cancel most of each
# term), the loss by 1e-4. Limits: the loss within 1e-2, the whole
# gradient within 0.2, each gradient within 0.25
RESNET_BF16_LOSS_TOL = 1e-2
RESNET_BF16_WHOLE_TOL = 0.2
RESNET_BF16_GRAD_TOL = 0.25
# served logits against a direct forward of the same requests at another
# batch (bf16: cuDNN takes other algorithms at another batch size), within
# this share of the largest logit; int8 rows (exact int32 products,
# calibrated static scales, fp32 in between) within 1e-3
RESNET_SERVE_TOL = {"bf16": 0.05, "int8": 1e-3}
RESNET_BUCKETS = (1, 8, 32)
RESNET_REQUESTS = 48
# the other families, one forward and backward each at batch 8 and its
# input size, on the card (fp32, TF32 off) against the same weights and
# inputs on the CPU: the logits within 1e-3 of the largest (fp32 through
# up to 120 layers, cuDNN's convolution algorithms against the CPU's;
# read 2.2e-7 to 2.3e-6 on an H100), each gradient within 2e-2 in
# relative L2. A gradient reaches the first layers through every ReLU and
# max-pool choice, and where two candidates of a window (or a
# pre-activation and 0) differ by less than the two libraries' rounding
# the gradient goes another way: the first run read 1.6e-6 (alexnet) to
# 5.6e-3 (vgg16_bn's first convolution) against a first guess of 1e-3
ZOO_FAMILIES = (("vgg16_bn", 224), ("alexnet", 224), ("squeezenet1.1", 224),
                ("mobilenet1.0", 224), ("mobilenetv2_1.0", 224),
                ("densenet121", 224), ("inceptionv3", 299),
                ("resnet18_v2", 224), ("resnet50_v1b", 224))
ZOO_BATCH = 8
ZOO_LOGIT_TOL = 1e-3
ZOO_GRAD_TOL = 2e-2


def _bias_before_bn(net):
    """The conv biases that feed a BatchNorm (the next block of their
    HybridSequential): their gradient is rounding alone in training."""
    from mxnet_tpu_torch.gluon import nn

    out = set()

    def walk(block):
        kids = list(block._children.values())
        for a, b in zip(kids, kids[1:]):
            if isinstance(a, nn.Conv2D) and isinstance(b, nn.BatchNorm) \
                    and a.bias is not None:
                out.add(a.bias.name)
        for k in kids:
            walk(k)

    walk(net)
    return out


def residual_gammas(net):
    """The gamma of each residual body's last BatchNorm (the zero-init
    residual start sets them to 0: Goyal et al., 2017)."""
    from mxnet_tpu_torch.gluon import nn

    out = []
    for block in net.modules():
        body = getattr(block, "body", None)
        if isinstance(body, nn.HybridSequential) and len(body) \
                and isinstance(body[len(body) - 1], nn.BatchNorm):
            out.append(body[len(body) - 1].gamma)
    return out


class ResNetTrainStep:
    """ResNet-50 v1 training through the port's entry points, as a user of
    the JAX package writes bench.py's recipe: ``resnet50_v1(classes=1000)``,
    one forward to shape the deferred parameters, amp bf16 (or fp32), the
    input cast at entry, ``autograd.record``, ``SoftmaxCrossEntropyLoss``,
    ``autograd.backward`` and ``gluon.Trainer("sgd")`` (RESNET_SGD), on one
    fixed batch from the seed."""

    timed = TrainStep.timed

    def __init__(self, dev, dtype="bfloat16", weights=None):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

        B, S = RESNET["batch"], RESNET["size"]
        self.net = resnet50_v1(classes=RESNET["classes"])
        self.net.initialize(
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        with torch.no_grad():
            self.net(torch.zeros(1, 3, S, S, device=dev))
        if dtype == "bfloat16":
            amp.convert_hybrid_block(self.net, "bfloat16")
        self.dtype = getattr(torch, dtype)
        self.named = self.net._collect_params_with_prefix()
        if weights is not None:  # another step's weights, in this dtype
            for name, p in self.named.items():
                p.set_data(weights[name]._tensor().detach().to(p.dtype))
        self.params = [p for p in self.net.collect_params().values()
                       if p.grad_req != "null"]
        self.stats = [p for p in self.net.collect_params().values()
                      if p.name.endswith(("running_mean", "running_var"))]
        self.trainer = gluon.Trainer(self.net.collect_params(), "sgd",
                                     RESNET_SGD)
        self.loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        rng = np.random.default_rng(SEED)
        self.x = torch.from_numpy(rng.normal(size=(B, 3, S, S)).astype(
            np.float32)).to(dev)
        self.y = torch.from_numpy(rng.integers(
            0, RESNET["classes"], (B,)).astype(np.int32)).to(dev)

    def __call__(self, update=True):
        """One step; returns the per-sample loss."""
        from mxnet_tpu_torch import autograd

        with autograd.record():
            loss = self.loss_fn(self.net(self.x.to(self.dtype)), self.y)
        autograd.backward(loss)
        if update:
            self.trainer.step(RESNET["batch"])
        return loss.detach()

    def saved_stats(self):
        return [p._tensor().detach().clone() for p in self.stats]

    def restore_stats(self, saved):
        """Write the moving statistics back in place (a training forward
        moves them)."""
        import torch

        with torch.no_grad():
            for p, s in zip(self.stats, saved):
                p._tensor().copy_(s)


def batchnorm_first_half(real, x, gamma, beta, moving_mean, moving_var,
                         **kw):
    """A planted fault in BatchNorm's training path: the batch statistics
    (the normalization's and the moving ones') from the first half of the
    batch only. Outside training it is ``real``, the op itself."""
    import torch

    if not kw.get("training") or kw.get("use_global_stats"):
        return real(x, gamma, beta, moving_mean, moving_var, **kw)
    dims = [d for d in range(x.dim()) if d != 1]
    var, mean = torch.var_mean(x[:max(1, x.shape[0] // 2)].float(),
                               dim=dims, unbiased=False)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = ((x.float() - mean.reshape(shape))
         * torch.rsqrt(var.reshape(shape) + kw.get("eps", 1e-5))
         * gamma.float().reshape(shape) + beta.float().reshape(shape))
    m = kw.get("momentum", 0.9)
    mean, var = mean.detach(), var.detach()
    return (y.to(x.dtype), m * moving_mean + (1 - m) * mean,
            m * moving_var + (1 - m) * var)


def xent_dx_last_columns_dropped(x, labels, lse, dy):
    """A planted fault in the softmax-xent plain version: each row's last
    8 columns of dx left at 0 (the last 8 classes never learn)."""
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    dx = sx.softmax_xent_bwd_plain(x, labels, lse, dy).clone()
    dx[:, -8:] = 0
    return dx


class batchnorm_fault:
    """Within the block, ``F.BatchNorm`` is ``fault(real_op, ...)`` (a
    planted fault)."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        from mxnet_tpu_torch.ops import functional as F

        self.real = real = F.BatchNorm
        F.BatchNorm = lambda *a, **kw: self.fault(real, *a, **kw)
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import functional as F

        F.BatchNorm = self.real


RESNET_FAULTS = {
    "BatchNorm statistics from the first half of the batch": (
        batchnorm_first_half, {}),
    "softmax-xent dx drops each row's last 8 columns": (
        None, {"softmax_xent_bwd": xent_dx_last_columns_dropped}),
    "none (the plain step again)": (None, {}),
}


def resnet_reading(step, loss, grads, stats, ref):
    """The step's loss, gradients and moving statistics against ``ref``'s
    (loss, grads, stats): the loss's |diff|, the worst three gradients'
    relative L2 and worst rows (conv biases before a BatchNorm left out),
    the worst moving statistic's relative L2."""
    skip = _bias_before_bn(step.net)
    keep = [i for i, p in enumerate(step.params) if p.name not in skip]
    params = [step.params[i] for i in keep]
    g = [grads[i] for i in keep]
    r = [ref[1][i] for i in keep]
    st = sorted(((float((a.float() - b.float()).norm()
                        / b.float().norm().clamp(min=1e-30)), p.name)
                 for p, a, b in zip(step.stats, stats, ref[2])),
                reverse=True)
    return {"loss_err": float((loss.mean() - ref[0].mean()).abs()),
            "worst_grad_rel_l2": [[v, n] for v, n in grad_rel_l2(
                params, g, r)[:3]],
            "worst_row_rel_l2": [[v, n] for v, n in grad_row_rel_l2(
                params, g, r)[:3]],
            "worst_stat_rel_l2": [list(s) for s in st[:3]],
            "held_params": len(params), "skipped_conv_biases": len(skip)}


def resnet_within(r):
    return (r["loss_err"] <= RESNET_LOSS_TOL
            and r["worst_grad_rel_l2"][0][0] <= RESNET_GRAD_TOL
            and r["worst_row_rel_l2"][0][0] <= RESNET_ROW_TOL
            and r["worst_stat_rel_l2"][0][0] <= RESNET_STAT_TOL)


def _one_step(step, saved, **faults):
    """One step without the update from the saved moving statistics, with
    the kernels (no argument) or the plain versions (``plain=True`` and
    the wrappers ``faults`` names, with ``bn`` a planted BatchNorm):
    (loss, grads, moving statistics after it)."""
    plain = faults.pop("plain", False)
    bn = faults.pop("bn", None)
    step.restore_stats(saved)
    if plain:
        with plain_versions(**faults):
            if bn is None:
                loss = step(update=False).float()
            else:
                with batchnorm_fault(bn):
                    loss = step(update=False).float()
    else:
        loss = step(update=False).float()
    out = (loss, _grads(step.params), step.saved_stats())
    step.restore_stats(saved)
    return out


def device_step_ms(step, n):
    """Median wall of ``n`` steps measured with CUDA events around each
    (the device's clock, from the first launch's enqueue to the last
    kernel's end), and the median host wall of the same steps."""
    import torch

    dev_ms, host_ms = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        step()
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    return float(np.median(dev_ms)), float(np.median(host_ms))


def batchnorm_probe(dev):
    """BatchNorm's moving variance on the card at N*H*W = 2, where the
    unbiased variance is twice the biased one: the port's new moving
    variance must be MXNet's (biased, momentum 0.5 here) within 1e-6, and
    torch's own training batch_norm (unbiased, a planted reading) must
    not."""
    import torch
    from mxnet_tpu_torch.ops import functional as F

    rng = np.random.default_rng(SEED + 31)
    x = rng.normal(size=(2, 16, 1, 1)).astype(np.float32)
    mm = rng.normal(size=16).astype(np.float32) * 0.1
    mv = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    want = 0.5 * mv + 0.5 * x.reshape(2, 16).var(axis=0)
    t = [torch.from_numpy(a).to(dev) for a in (x, mm, mv)]
    g = torch.ones(16, device=dev)
    b = torch.zeros(16, device=dev)
    _, _, got = F.BatchNorm(t[0].to(torch.bfloat16), g, b, t[1], t[2],
                            training=True, momentum=0.5)
    xb = t[0].to(torch.bfloat16).float().cpu().numpy().reshape(2, 16)
    want_b = 0.5 * mv + 0.5 * xb.var(axis=0)
    err = float(np.abs(got.cpu().numpy() - want_b).max())
    rv = t[2].clone()
    torch.nn.functional.batch_norm(t[0], t[1].clone(), rv, g, b, True, 0.5)
    planted = float(np.abs(rv.cpu().numpy() - want).max())
    print("BatchNorm probe at N*H*W = 2 on the card: new moving variance "
          "|port - biased| %.3g (limit 1e-6); torch's unbiased batch_norm "
          "|.| %.3g (must exceed it)" % (err, planted), flush=True)
    check(err <= 1e-6, "BatchNorm's moving variance is not the biased one")
    check(planted > 1e-6, "the probe cannot see an unbiased variance")
    return {"max_abs_err": err, "unbiased_planted_err": planted}


def phase_resnet_train(dev):
    """ResNet-50 v1 trained at bench.py's recipe on the card: the main
    path (RESNET_STEPS steps on one fixed batch: the loss falls, exact
    softmax-xent launches), one step with the kernels against the same
    step with the plain versions and with planted faults, the bf16 step
    against the fp32 step, the BatchNorm probe, the step's wall by CUDA
    events and by the host, images/s, peak memory, and the step with
    ``cudnn.benchmark`` on."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step = ResNetTrainStep(dev)
    B = RESNET["batch"]
    n_params = sum(p._tensor().numel() for p in step.params)
    torch.cuda.synchronize()
    print("resnet50_v1 train step: %d trained parameters, batch %d at %dx%d,"
          " bf16 (fp32 masters and BatchNorm); set-up %.2f s"
          % (n_params, B, RESNET["size"], RESNET["size"],
             time.perf_counter() - t0), flush=True)
    watch = [step.params[0], step.params[-1]]
    before = [p._tensor().detach().clone() for p in watch]

    # the main path, with every counter at 0 just before it
    mx_random.seed(SEED)
    reset_counters()
    t0 = time.perf_counter()
    losses = [float(step().mean()) for _ in range(RESNET_STEPS)]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counters()
    print("resnet50 losses over %d steps on one batch: %s; kernel launches: "
          "%s (%.2f s)" % (RESNET_STEPS, ["%.4f" % v for v in losses],
                           launches, main_s), flush=True)
    check(all(np.isfinite(losses)), "non-finite resnet50 loss")
    check(losses[-1] < losses[0], "the resnet50 loss did not fall: %s"
          % losses)
    for p, b in zip(watch, before):
        check(not torch.equal(p._tensor(), b), "resnet50: %s did not move"
              % p.name)
    del before
    for name, n in launches.items():
        want = RESNET_STEP_LAUNCHES.get(name, 0) * RESNET_STEPS
        check(n == want, "resnet50 %s launches %d != %d" % (name, n, want))

    # one step with the kernels against the plain versions, and planted
    # faults in the plain step
    saved = step.saved_stats()
    kern = _one_step(step, saved)
    for p, g in zip(step.params, kern[1]):
        check(bool(torch.isfinite(g).all()), "resnet50 %s: non-finite grad"
              % p.name)
    reset_counters()
    plain = _one_step(step, saved, plain=True)
    check(not any(read_counters().values()),
          "the plain-version resnet50 step launched a kernel: %s"
          % read_counters())
    honest = resnet_reading(step, *kern, plain)
    print("resnet50 step with kernels vs plain versions: loss |diff| %.3g "
          "(limit %g); worst gradient relative L2 %s (limit %g); worst row "
          "%s (limit %g); worst moving statistic %s (limit %g); %d "
          "parameters held, %d conv biases before a BatchNorm not held"
          % (honest["loss_err"], RESNET_LOSS_TOL,
             ["%.3g %s" % tuple(r) for r in honest["worst_grad_rel_l2"]],
             RESNET_GRAD_TOL,
             ["%.3g %s" % tuple(r) for r in honest["worst_row_rel_l2"]],
             RESNET_ROW_TOL,
             ["%.3g %s" % tuple(r) for r in honest["worst_stat_rel_l2"]],
             RESNET_STAT_TOL, honest["held_params"],
             honest["skipped_conv_biases"]), flush=True)
    check(resnet_within(honest), "resnet50 step disagrees with the plain "
          "versions: %s" % honest)
    faults = {}
    for name, (bn, wrappers) in RESNET_FAULTS.items():
        got = _one_step(step, saved, plain=True, bn=bn, **wrappers)
        faults[name] = resnet_reading(step, *got, plain)
        faults[name]["caught"] = not resnet_within(faults[name])
        print("resnet50 step, planted fault %r: loss |diff| %.3g, worst "
              "gradient %s, worst row %s, worst statistic %s; caught %s"
              % (name, faults[name]["loss_err"],
                 ["%.3g %s" % tuple(r)
                  for r in faults[name]["worst_grad_rel_l2"][:1]],
                 ["%.3g %s" % tuple(r)
                  for r in faults[name]["worst_row_rel_l2"][:1]],
                 ["%.3g %s" % tuple(r)
                  for r in faults[name]["worst_stat_rel_l2"][:1]],
                 faults[name]["caught"]), flush=True)
        check(faults[name]["caught"] == (bn is not None or bool(wrappers)),
              "the resnet50 step's limits %s %r" % (
                  "miss the planted fault" if bn is not None or wrappers
                  else "refuse", name))
    del plain

    # the bf16 step against the fp32 step (TF32 off) from the same
    # bf16-rounded weights, at the zero-init residual start (RESNET_BF16_*)
    gammas = residual_gammas(step.net)
    kept = [g._tensor().detach().clone() for g in gammas]
    with torch.no_grad():
        for g in gammas:
            g._tensor().zero_()
    step.restore_stats(saved)
    low = (step(update=False).float(), _grads(step.params))
    f32 = ResNetTrainStep(dev, "float32", weights=step.named)
    f32.restore_stats(saved)
    ref = (f32(update=False).float(), _grads(f32.params))
    with torch.no_grad():
        for g, k in zip(gammas, kept):
            g._tensor().copy_(k)
    step.restore_stats(saved)
    skip = _bias_before_bn(step.net)
    # the two nets' parameters by structural name (their roots' auto names
    # differ)
    local = {id(p): n for n, p in step.named.items()}
    by_name = {n: g for n, p in f32.named.items()
               for q, g in zip(f32.params, ref[1]) if q is p}
    pairs = [(p.name, g.float(), by_name[local[id(p)]])
             for p, g in zip(step.params, low[1]) if p.name not in skip]
    rel = sorted(((float((g - r).norm() / r.norm().clamp(min=1e-30)), n)
                  for n, g, r in pairs if r.norm() > 0), reverse=True)
    whole = float(torch.cat([(g - r).reshape(-1) for _, g, r in pairs])
                  .norm() / torch.cat([r.reshape(-1) for _, _, r in pairs])
                  .norm())
    loss_rel = float((low[0].mean() - ref[0].mean()).abs()
                     / ref[0].mean().abs())
    bf16_vs_fp32 = {"loss": [float(low[0].mean()), float(ref[0].mean())],
                    "loss_rel_err": loss_rel, "whole_grad_rel_l2": whole,
                    "worst_grad_rel_l2": [list(r) for r in rel[:5]],
                    "median_grad_rel_l2": float(np.median([r[0]
                                                           for r in rel])),
                    "zeroed_gammas": len(gammas)}
    print("resnet50 bf16 step vs fp32 step (zero-init residual start, %d "
          "gammas at 0): loss %.5f vs %.5f (relative %.3g, limit %g); "
          "gradient relative L2 of the whole %.3g (limit %g), median %.3g, "
          "worst %s (limit %g)"
          % (len(gammas), bf16_vs_fp32["loss"][0], bf16_vs_fp32["loss"][1],
             loss_rel, RESNET_BF16_LOSS_TOL, whole, RESNET_BF16_WHOLE_TOL,
             bf16_vs_fp32["median_grad_rel_l2"],
             ["%.3g %s" % tuple(r) for r in rel[:3]], RESNET_BF16_GRAD_TOL),
          flush=True)
    check(loss_rel <= RESNET_BF16_LOSS_TOL and whole <= RESNET_BF16_WHOLE_TOL
          and rel[0][0] <= RESNET_BF16_GRAD_TOL,
          "the resnet50 bf16 step leaves the fp32 step's")
    del f32, ref, low, by_name, kern
    torch.cuda.empty_cache()
    probe = batchnorm_probe(dev)

    # the step's wall, images/s and peak memory, then cudnn.benchmark on
    step.timed(2)
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    dev_ms, host_ms = device_step_ms(step, RESNET_TIMED)
    peak = torch.cuda.max_memory_allocated() / 1e9
    result = {"recipe": dict(RESNET, sgd=RESNET_SGD, dtype="bfloat16"),
              "losses": losses, "launches": launches,
              "steps_counted": RESNET_STEPS, "vs_plain": honest,
              "planted_faults": faults, "bf16_vs_fp32": bf16_vs_fp32,
              "batchnorm_probe": probe,
              "step_ms_cuda_events_median": dev_ms,
              "step_ms_host_median": host_ms,
              "images_per_s": B / host_ms * 1e3,
              "peak_memory_gb": peak,
              "allocated_before_steps_gb": held_gb,
              "yardsticks": {
                  "bench_flop_per_step": RESNET_FLOP_PER_IMAGE * B,
                  "bound_ms_at_989_tflops": RESNET_FLOP_PER_IMAGE * B
                  / PEAK_BF16 * 1e3,
                  "a100_baseline_step_ms": B / RESNET_A100_IMG_S * 1e3}}
    print("resnet50 train step: median %.3f ms by CUDA events, %.3f ms by "
          "the host over %d steps; %.1f images/s; peak memory %.2f GB "
          "(%.2f GB allocated before the steps: the model, its optimizer "
          "state and whatever earlier phases hold) (yardsticks: %.2f ms at "
          "989 TFLOP/s for bench.py's 23.52 GFLOP an image, %.1f ms a step "
          "at the A100 baseline's 2900 images/s)"
          % (dev_ms, host_ms, RESNET_TIMED, result["images_per_s"], peak,
             held_gb,
             result["yardsticks"]["bound_ms_at_989_tflops"],
             result["yardsticks"]["a100_baseline_step_ms"]), flush=True)
    torch.backends.cudnn.benchmark = True
    try:
        step.timed(3)
        bench_dev, bench_host = device_step_ms(step, RESNET_TIMED)
    finally:
        torch.backends.cudnn.benchmark = False
    result["cudnn_benchmark"] = {"step_ms_cuda_events_median": bench_dev,
                                 "step_ms_host_median": bench_host,
                                 "images_per_s": B / bench_host * 1e3}
    print("resnet50 train step with cudnn.benchmark on: median %.3f ms by "
          "CUDA events, %.3f ms by the host (%.1f images/s)"
          % (bench_dev, bench_host, B / bench_host * 1e3), flush=True)
    return step, result


def _vision_kernel_class(name):
    for key, cls in (("xent_fwd_kernel", "softmax_xent_fwd"),
                     ("xent_bwd_kernel", "softmax_xent_bwd"),
                     ("multi_tensor_apply", "optimizer (foreach)"),
                     ("dgrad", "conv dgrad"), ("wgrad", "conv wgrad"),
                     ("fprop", "conv forward"),
                     ("batch_norm", "batchnorm"), ("bn_", "batchnorm"),
                     ("welford", "batchnorm"),
                     ("max_pool", "pooling"), ("avg_pool", "pooling"),
                     ("nchwToNhwc", "layout"), ("nhwcToNchw", "layout"),
                     ("threshold", "relu+add"), ("clamp_min", "relu+add"),
                     ("AddFunctor", "relu+add"), ("add_kernel", "relu+add")):
        if key in name:
            return cls
    if any(s in name for s in ("conv", "implicit", "winograd")):
        return "conv (other)"
    if any(s in name for s in ("gemm", "xmma", "cutlass", "nvjet")):
        return "gemm"
    if "reduce_kernel" in name:
        return "reduction"
    return "other"


def phase_resnet_breakdown(step, n_prof=2, label="resnet50 train step"):
    """Where a vision step's time goes (ResNet-50's unless ``label`` names
    another), from one torch.profiler window after the timed steps: kernel
    ms a step by class (cuDNN's convolution forward, dgrad and wgrad,
    BatchNorm, relu and the residual add, pooling, the optimizer's
    foreach, the softmax-xent kernels), the profiled wall and the device's
    idle share, and the top kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_prof):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_prof
    by_class, top = {}, []
    for ev in prof.key_averages():
        # kernels only: a profiler range's device-side event is its span
        if ev.device_type != DeviceType.CUDA \
                or ev.key.startswith("mxnet_tpu_torch::"):
            continue
        ms = ev.self_device_time_total / 1e3 / n_prof
        cls = _vision_kernel_class(ev.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms
        top.append((ms, ev.count // n_prof, cls, ev.key[:80]))
    top.sort(reverse=True)
    busy = sum(by_class.values())
    out = {"kernel_ms_per_step": by_class, "profiled_wall_ms_per_step": wall,
           "device_busy_ms_per_step": busy,
           "device_idle_share": 1.0 - busy / wall, "top": top[:15]}
    print("%s breakdown (torch.profiler, %d steps): kernel ms a step by "
          "class %s; %.3f ms busy in %.3f ms of wall: device idle %.1f%%"
          % (label, n_prof, {k: round(v, 3) for k, v in sorted(
              by_class.items())}, busy, wall, 100 * out["device_idle_share"]),
          flush=True)
    for ms, n, cls, name in top[:15]:
        print("  %8.4f ms  x%-4d %-20s %s" % (ms, n, cls, name))
    check(busy > 0, "the profiler saw no kernel time")
    return out


def phase_resnet_timing(dev, records, resnet):
    """The softmax-xent kernels at the ResNet-50 step's shape, (128, 1000)
    bf16 logits with dy = 1 (the loss summed by the backward, then the
    trainer's 1 / batch), each held to its plain version and timed
    against it, ``F.cross_entropy`` and its bound, added to their records
    under ``resnet50_train`` with the main path's launches."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    rec = {r["name"]: r for r in records}
    R, V = RESNET["batch"], RESNET["classes"]
    launches, steps = resnet["launches"], resnet["steps_counted"]
    x = (torch.randn(R, V, device=dev, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    labels[0] = V - 1
    dy = torch.ones(R, device=dev)
    what = "resnet50 train softmax-xent (%d, %d) bf16" % (R, V)
    loss, lse = sx.softmax_xent_fwd(x, labels)
    torch.cuda.synchronize()
    ref_loss, ref_lse = sx.softmax_xent_fwd_plain(x, labels)
    fwd = held(loss, ref_loss, XENT_TOL, what + " loss")
    fwd["lse"] = held(lse, ref_lse, XENT_TOL, what + " lse")
    dx = sx.softmax_xent_bwd(x, labels, ref_lse, dy)
    torch.cuda.synchronize()
    bwd = held(dx, sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy),
               XENT_DX_TOL["bfloat16"], what + " dx")
    xf = x.float().requires_grad_()
    lab64 = labels.long()

    def lib_fwd():
        return TF.cross_entropy(xf, lab64, reduction="none")

    def lib_fwd_bwd():
        return torch.autograd.grad(lib_fwd(), xf, dy)

    ms, plain_ms, lib_ms, lib_both = time_ms(
        lambda: sx.softmax_xent_fwd(x, labels),
        lambda: sx.softmax_xent_fwd_plain(x, labels), lib_fwd, lib_fwd_bwd)
    bwd_ms, bwd_plain_ms = time_ms(
        lambda: sx.softmax_xent_bwd(x, labels, ref_lse, dy),
        lambda: sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy))
    ops = 5 * R * V
    xbytes = R * V * x.element_size()
    for name, t, plain_t, lib_t, reading, nbytes, lib in (
            ("softmax_xent_fwd", ms, plain_ms, lib_ms, fwd,
             xbytes + 3 * R * 4,
             "F.cross_entropy(reduction='none') on fp32 logits"),
            ("softmax_xent_bwd", bwd_ms, bwd_plain_ms, lib_both - lib_ms,
             bwd, 2 * xbytes + 3 * R * 4,
             "backward of F.cross_entropy on fp32 logits (forward + "
             "backward less forward)")):
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        out = {"ms": t, "plain_ms": plain_t, "library_ms": lib_t,
               "launches": launches[name],
               "launches_per_step": launches[name] / steps, "shape": [R, V],
               "max_abs_err": reading["max_abs_err"], "check": reading,
               "bound_ms": max(t_ops, t_bytes) * 1e3,
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "library": lib}
        rec[name]["resnet50_train"] = out
        print("time resnet50 train %-17s at %s: kernel %.4f ms, plain %.4f "
              "ms, library %.4f ms, bound %.4f ms (%s), %g launches a step"
              % (name, [R, V], t, plain_t, lib_t, out["bound_ms"],
                 out["bound_by"], out["launches_per_step"]), flush=True)


def _bf16_entry(net):
    """``net`` behind a cast of its fp32 input to bf16 (bench.py's entry
    cast), as one block for a server."""
    from mxnet_tpu_torch.gluon import nn

    wrap = nn.HybridSequential()
    wrap.add(nn.HybridLambda(lambda F, x: F.cast(x, dtype="bfloat16")), net)
    return wrap


def _serving_resnet(dev, source):
    """A new bf16 resnet50_v1 holding ``source``'s weights and moving
    statistics (a trained step's net), behind the bf16 entry cast."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1

    S = RESNET["size"]
    net = resnet50_v1(classes=RESNET["classes"])
    net.initialize(device=dev)
    with torch.no_grad():
        net(torch.zeros(1, 3, S, S, device=dev))
    amp.convert_hybrid_block(net, "bfloat16")
    theirs = source._collect_params_with_prefix()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(theirs[name]._tensor().detach().clone().to(p.dtype))
    return _bf16_entry(net)


def _serve_burst(srv, reqs):
    """Submit every request, wait for all: (rows in order, stats delta of
    the graph keys, forwards)."""
    b0 = srv.metrics.batches
    handles = [srv.submit(r) for r in reqs]
    rows = [h.result(timeout_s=300)[0] for h in handles]
    return np.concatenate(rows), srv.metrics.batches - b0


def quant_conv_exact(dev, model, n=8):
    """The int8 quantized convolution at every distinct shape of the
    quantized ResNet-50 (its layers' inputs at batch ``n``, found by one
    forward): ``quantized_conv_acc`` on random int8 operands of those
    shapes equals the fp64 convolution of the same operands, read as
    integers (exact: every sum is an integer below 2**53)."""
    import torch
    from mxnet_tpu_torch.ops import lowbit
    from mxnet_tpu_torch.quantization import QuantizedConv2D

    shapes = {}
    hooks = []
    for block in model.modules():
        if isinstance(block, QuantizedConv2D):
            def hook(b, args, out, block=block):
                k = block._conv_kw
                shapes.setdefault((tuple(args[0].shape), tuple(
                    block.qweight.shape), tuple(k["stride"]),
                    tuple(k["pad"])), block)
            hooks.append(block.register_forward_hook(hook))
    try:
        with torch.inference_mode():
            model(torch.zeros(n, 3, RESNET["size"], RESNET["size"],
                              device=dev))
    finally:
        for h in hooks:
            h.remove()
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    worst = 0
    for (xs, ws, stride, pad), block in sorted(shapes.items()):
        qx = torch.randint(-127, 128, xs, device=dev, generator=g,
                           dtype=torch.int8)
        qw = block.qweight._tensor()
        acc = lowbit.quantized_conv_acc(qx, qw, stride, pad)
        ref = torch.nn.functional.conv2d(qx.double(), qw.double(),
                                         stride=stride, padding=pad)
        diff = int((acc.to(torch.int64) - ref.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        check(acc.dtype == torch.int32 and diff == 0,
              "int8 quantized conv at %s x %s differs from the exact "
              "product by %d" % (xs, ws, diff))
    print("int8 quantized conv at %d distinct ResNet-50 shapes (batch %d): "
          "equal to the exact product of the same operands" % (len(shapes),
                                                               n), flush=True)
    return {"shapes": len(shapes), "max_abs_err": worst}


def phase_resnet_serve(dev, source):
    """ResNet-50 (``source``'s trained weights, eval mode: the moving
    statistics) served through ``ModelServer(buckets=(1, 8, 32))`` in bf16
    and then int8 (naive calibration): one CUDA graph a bucket, each
    bucket's replay bitwise equal to an eager run of the same padded
    batch, no capture in traffic, served rows against a direct forward,
    the int8 convolution at the model's shapes against the exact product,
    and the top-1 agreement of int8 with bf16."""
    import torch
    from mxnet_tpu_torch.serve import ModelServer

    S = RESNET["size"]
    specs = [((3, S, S), "float32")]
    rng = np.random.default_rng(SEED + 61)
    reqs = rng.normal(size=(RESNET_REQUESTS, 3, S, S)).astype(np.float32)
    calib = rng.normal(size=(8, 3, S, S)).astype(np.float32)
    out = {}
    tops = {}
    for mode in ("bf16", "int8"):
        model = _serving_resnet(dev, source)
        t0 = time.perf_counter()
        srv = ModelServer(model, specs, buckets=RESNET_BUCKETS,
                          max_wait_ms=5.0, timeout_ms=300000.0, device=dev,
                          quantize=None if mode == "bf16" else "int8",
                          calib_mode="none" if mode == "bf16" else "naive",
                          calib_data=None if mode == "bf16" else [calib])
        torch.cuda.synchronize()
        warm = srv.stats()
        what = "%s ResNet-50 server" % mode
        print("%s warmup (buckets %s, one CUDA graph each): %.2f s; %s"
              % (what, list(RESNET_BUCKETS), time.perf_counter() - t0,
                 {k: warm[k] for k in GRAPH_KEYS}), flush=True)
        check_warm_graphs(warm, RESNET_BUCKETS, what)
        eq = {}
        for b in RESNET_BUCKETS:
            ins = [reqs[:b]]
            graph_out = srv._pool.run(ins)
            eager_out = srv._pool.run(ins, eager=True)
            eq[b] = outputs_equal(graph_out, eager_out)
            check(eq[b], "%s bucket %d: graph replay differs from eager"
                  % (what, b))
        replay_ms, eager_ms = bucket_device_ms(srv._pool, RESNET_BUCKETS[-1])
        print("%s bucket %d on the device: a graph replay %.3f ms, an eager "
              "forward's span %.3f ms" % (what, RESNET_BUCKETS[-1], replay_ms,
                                          eager_ms), flush=True)
        with srv:
            stats0 = srv.stats()
            reset_counters()
            t0 = time.perf_counter()
            served, forwards = _serve_burst(srv, list(reqs))
            wall = time.perf_counter() - t0
            counts = read_counters()
            stats = srv.stats()
        check(stats["captures"] == stats0["captures"] and stats["drops"] == 0
              and stats["replays"] == stats0["replays"] + forwards,
              "%s traffic captured a graph or ran without one: %s"
              % (what, {k: stats[k] for k in GRAPH_KEYS}))
        check(stats["errors"] == 0, "%s errors: %s" % (what, stats))
        check(not any(counts.values()), "%s launched a port kernel: %s"
              % (what, counts))
        with torch.inference_mode():
            direct = np.concatenate([
                model(torch.from_numpy(reqs[i:i + 16]).to(dev)).float()
                .cpu().numpy() for i in range(0, len(reqs), 16)])
        check(served.shape == (RESNET_REQUESTS, RESNET["classes"])
              and np.isfinite(served).all(), "%s served rows" % what)
        err = float(np.abs(served - direct).max() / np.abs(direct).max())
        tops[mode] = direct.argmax(axis=1)
        agree = float((served.argmax(axis=1) == tops[mode]).mean())
        print("%s: %d requests in %d forwards (%.1f ms wall, %.1f req/s); "
              "served rows vs a direct forward: max |diff| / max |logit| "
              "%.3g (limit %g), top-1 equal on %.3f"
              % (what, RESNET_REQUESTS, forwards, wall * 1e3,
                 RESNET_REQUESTS / wall, err, RESNET_SERVE_TOL[mode], agree),
              flush=True)
        check(err <= RESNET_SERVE_TOL[mode], "%s rows disagree with a "
              "direct forward" % what)
        out[mode] = {"graph_equals_eager": eq, "forwards": forwards,
                     "bucket_%d_replay_ms" % RESNET_BUCKETS[-1]: replay_ms,
                     "bucket_%d_eager_span_ms" % RESNET_BUCKETS[-1]: eager_ms,
                     "wall_ms": wall * 1e3, "rows_vs_direct": err,
                     "top1_served_vs_direct": agree,
                     "server_stats": {k: stats[k] for k in GRAPH_KEYS}}
        if mode == "int8":
            out[mode]["quant_conv_exact"] = quant_conv_exact(dev, model)
        del srv, model
        torch.cuda.empty_cache()
    out["int8_top1_agreement_with_bf16"] = float(
        (tops["int8"] == tops["bf16"]).mean())
    print("ResNet-50 int8 top-1 agreement with bf16 on %d requests: %.3f"
          % (RESNET_REQUESTS, out["int8_top1_agreement_with_bf16"]),
          flush=True)
    return out


def _zoo_run(net, x, cot, dev):
    """One forward and backward of ``net`` in predict mode (BatchNorm with
    its moving statistics, dropout off) on ``dev``: (logits, {name:
    gradient})."""
    import torch
    from mxnet_tpu_torch import autograd

    with autograd.record(train_mode=False):
        y = net(x.to(dev))
    autograd.backward(y, cot.to(dev))
    named = net._collect_params_with_prefix()
    return y.detach().cpu(), {n: p._tensor().grad.detach().cpu() for n, p in
                              named.items() if p.grad_req != "null"}


def phase_vision_zoo(dev):
    """Every other family of the zoo, one forward and backward at batch 8
    and its input size on the card (fp32, TF32 off) against the same
    weights and inputs on the CPU (ZOO_LOGIT_TOL, ZOO_GRAD_TOL). Predict
    mode: at random weights a training BatchNorm at batch 8 makes a deep
    network chaotic (tests/test_torch_port_resnet_step.py), which no
    tolerance between two libraries could hold; BatchNorm's training path
    is the ResNet-50 step's."""
    import torch
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model

    cpu = torch.device("cpu")
    out = {}
    for i, (name, size) in enumerate(ZOO_FAMILIES):
        t0 = time.perf_counter()
        host = get_model(name, classes=1000)
        host.initialize(device=cpu,
                        generator=torch.Generator().manual_seed(SEED + i))
        with torch.no_grad():
            host(torch.zeros(1, 3, size, size))
        card = get_model(name, classes=1000)
        theirs = host._collect_params_with_prefix()
        for n, p in card._collect_params_with_prefix().items():
            p.set_data(theirs[n]._tensor().detach().clone().to(dev))
        rng = np.random.default_rng(SEED + 71 + i)
        x = torch.from_numpy(rng.normal(
            size=(ZOO_BATCH, 3, size, size)).astype(np.float32))
        cot = torch.from_numpy(rng.normal(size=(ZOO_BATCH, 1000)).astype(
            np.float32))
        y_card, g_card = _zoo_run(card, x, cot, dev)
        torch.cuda.synchronize()
        t_card = time.perf_counter() - t0
        y_host, g_host = _zoo_run(host, x, cot, cpu)
        logit_err = float((y_card - y_host).abs().max()
                          / y_host.abs().max().clamp(min=1e-30))
        rel = sorted(((float((g_card[n] - g_host[n]).norm()
                             / g_host[n].norm().clamp(min=1e-30)), n)
                      for n in g_host if g_host[n].norm() > 0),
                     reverse=True)
        out[name] = {"input": [ZOO_BATCH, 3, size, size],
                     "logit_rel_err": logit_err,
                     "worst_grad_rel_l2": [list(r) for r in rel[:3]],
                     "params": len(g_host),
                     "seconds": time.perf_counter() - t0,
                     "card_seconds": t_card}
        print("zoo %-16s batch %d at %dx%d: logits max |card - cpu| / max "
              "|cpu| %.3g (limit %g); worst gradient relative L2 %s (limit "
              "%g) over %d parameters; %.1f s (card %.1f s)"
              % (name, ZOO_BATCH, size, size, logit_err, ZOO_LOGIT_TOL,
                 ["%.3g %s" % tuple(r) for r in rel[:2]], ZOO_GRAD_TOL,
                 len(g_host), out[name]["seconds"], t_card), flush=True)
        check(torch.isfinite(y_card).all() and y_card.shape == (
            ZOO_BATCH, 1000), "zoo %s: logits" % name)
        check(logit_err <= ZOO_LOGIT_TOL, "zoo %s: logits disagree with "
              "the CPU's" % name)
        check(rel[0][0] <= ZOO_GRAD_TOL, "zoo %s: gradients disagree with "
              "the CPU's" % name)
        del host, card, g_card, g_host
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- nd


def _nd_step(nd_mod, step, ctx):
    """One step of ``step``'s model and trainer written as an MXNet user
    writes it: tokens through ``nd.array``, the loss recorded, then
    ``loss.backward()``, ``trainer.step`` and ``loss.mean().asscalar()``."""
    from mxnet_tpu_torch import autograd

    x = nd_mod.array(step.inp_np, ctx=ctx, dtype="int32")
    y = nd_mod.array(step.tgt_np, ctx=ctx, dtype="int32")
    with autograd.record():
        loss = step.loss_fn(step.model(x), y)
    loss.backward()
    step.trainer.step(GPT_TRAIN["batch"])
    mean = loss.mean().asscalar()
    return loss, mean


def _param_gap(a, b):
    """max |a - b| over every parameter of two steps' models, and the
    count of parameters that differ at all."""
    import torch

    worst, n = 0.0, 0
    for p, q in zip(a.params, b.params):
        pa, pb = p._tensor().detach(), q._tensor().detach()
        if not torch.equal(pa, pb):
            n += 1
            worst = max(worst, max_err(pa, pb))
    return worst, n


def phase_nd_train(dev):
    """GPT-2 small at ``GPT_TRAIN``'s recipe (batch 8 x 1024, dropout 0.1,
    bf16, Adam with fp32 masters, full width) trained for three steps in
    MXNet's imperative idiom (``_nd_step``), from the state and generator
    seed ``phase_gpt_train`` starts from, beside the same steps through the
    tensor path twice (A and C). The flash backward's dq sums in no fixed
    order, so the tensor path is not bit-reproducible from run to run;
    the NDArray step (B) must equal A bit for bit wherever C does, and
    elsewhere differ from A by no more than C does (within 4x, over every
    parameter). The first step's loss (before any update) must be bitwise
    A's, every step's kernel launches ``GPT_STEP_LAUNCHES``, and the host
    wall of a step is printed for both paths: the NDArray layer's cost."""
    import torch
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.context import context_from_device

    ctx = context_from_device(dev)
    steps = {k: GPTTrainStep(dev) for k in "ABC"}
    seq = np.random.default_rng(SEED).integers(
        0, GPT_CONFIG["vocab_size"],
        (GPT_TRAIN["batch"], GPT_TRAIN["seq"] + 1)).astype(np.int32)
    steps["B"].inp_np = np.ascontiguousarray(seq[:, :-1])
    steps["B"].tgt_np = np.ascontiguousarray(seq[:, 1:])
    check(torch.equal(torch.from_numpy(steps["B"].inp_np).to(dev),
                      steps["A"].inp), "nd tokens differ from the step's")
    walls = {"tensor": [], "nd": []}
    rows = []
    for i in range(GPT_TRAIN_STEPS):
        losses = {}
        for k in "AC":
            mx_random.seed(SEED + i)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses[k] = steps[k]()
            float(losses[k].mean())
            torch.cuda.synchronize()
            if k == "A":
                walls["tensor"].append((time.perf_counter() - t0) * 1e3)
        mx_random.seed(SEED + i)
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        loss_b, mean_b = _nd_step(nd, steps["B"], ctx)
        torch.cuda.synchronize()
        walls["nd"].append((time.perf_counter() - t0) * 1e3)
        launches = read_counters()
        gap_ba, n_ba = _param_gap(steps["B"], steps["A"])
        gap_ca, n_ca = _param_gap(steps["C"], steps["A"])
        lb = loss_b._data.detach()
        row = {"step": i, "loss_nd": mean_b,
               "loss_tensor": float(losses["A"].mean()),
               "loss_bitwise": bool(torch.equal(lb, losses["A"])),
               "loss_c_bitwise": bool(torch.equal(losses["C"],
                                                  losses["A"])),
               "params_differing_nd": n_ba, "max_param_gap_nd": gap_ba,
               "params_differing_c": n_ca, "max_param_gap_c": gap_ca,
               "launches": launches}
        rows.append(row)
        print("nd train step %d: loss %.6f (tensor path %.6f, bitwise %s; "
              "second tensor run bitwise %s); parameters differing from the "
              "tensor path: NDArray %d (max %.3g), second tensor run %d (max "
              "%.3g); launches %s" % (
                  i, mean_b, row["loss_tensor"], row["loss_bitwise"],
                  row["loss_c_bitwise"], n_ba, gap_ba, n_ca, gap_ca,
                  launches), flush=True)
        check(isinstance(loss_b, nd.NDArray), "the nd loss is no NDArray")
        if i == 0:
            check(row["loss_bitwise"], "nd step 0: the loss is not the "
                  "tensor path's bit for bit")
        if n_ca == 0 and row["loss_c_bitwise"]:
            check(n_ba == 0 and row["loss_bitwise"],
                  "nd step %d differs from a tensor path that reproduced "
                  "itself" % i)
        else:
            check(gap_ba <= 4 * gap_ca and n_ba <= 4 * max(n_ca, 1),
                  "nd step %d: gap %.3g over %d parameters, beyond the "
                  "tensor path's own %.3g over %d" % (i, gap_ba, n_ba,
                                                       gap_ca, n_ca))
        for name, n in GPT_STEP_LAUNCHES.items():
            check(launches[name] == n, "nd step %d: %s launches %d != %d"
                  % (i, name, launches[name], n))
        check(launches["flash_attention_fwd_f32"] == 0,
              "nd step launched the fp32 flash form")
    # the first step of the phase (the tensor path's) also pays the
    # phase's first launches: the medians are of the later steps
    out = {"steps": rows,
           "host_wall_ms": {k: v for k, v in walls.items()},
           "host_wall_ms_median_after_first": {
               k: float(np.median(v[1:])) for k, v in walls.items()}}
    print("nd train: host wall a step %s ms (tensor path) vs %s ms "
          "(NDArray idiom), medians after the first step %.3f vs %.3f ms; "
          "%s" % (["%.2f" % w for w in walls["tensor"]],
                  ["%.2f" % w for w in walls["nd"]],
                  out["host_wall_ms_median_after_first"]["tensor"],
                  out["host_wall_ms_median_after_first"]["nd"], card_line()),
          flush=True)
    del steps
    torch.cuda.empty_cache()
    return out


def _rel(a, b):
    """|a - b| / |b| in L2, in fp64 (an lse's error is under fp32's ulp)."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp(min=1e-300))


# the kernel-backed nd ops against their plain versions on the card:
# relative L2 of each output and gradient; bf16 outputs are rounded once
# to bf16 on each side (2**-8 relative a value), fp32 ones sum in another
# order
ND_KERNEL_REL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# their inputs: a GPT-2 step's LayerNorm rows (8 x 1024 of 768), 2048 of
# its logits rows (of GPT_CONFIG's vocabulary), a causal flash at T = 1024
ND_KERNEL_SHAPES = {"layernorm": (8, 1024, 768), "xent_rows": 2048,
                    "flash": (2, 12, 1024, 64)}


def _nd_kernel_case(nd, autograd, name, fn, inputs, dtype):
    """fn(*inputs) recorded and backward with random head weights, as the
    kernel path and inside ``plain_versions()``; the launches of the first,
    the readings and the errors."""
    import torch

    def run():
        arrs = [nd.NDArray(t.clone()) for t in inputs]
        for a in arrs:
            if a._data.is_floating_point():
                a.attach_grad()
        with autograd.record():
            out = fn(*arrs)
        w = torch.randn(out.shape, device=out._data.device,
                        generator=torch.Generator(out._data.device)
                        .manual_seed(SEED)).to(out._data.dtype)
        out.backward(nd.NDArray(w))
        return [out._data.detach()] + [a.grad._data for a in arrs
                                       if a.grad is not None]

    reset_counters()
    got = run()
    torch.cuda.synchronize()
    launches = read_counters()
    with plain_versions():
        reset_counters()
        ref = run()
        plain_launches = sum(read_counters().values())
    errs = [_rel(g, r) for g, r in zip(got, ref)]
    tol = ND_KERNEL_REL[dtype]
    print("nd.%s on the card: launches %s, relative L2 against the plain "
          "versions (output, then each input's gradient) %s (limit %g)"
          % (name, {k: v for k, v in launches.items() if v},
             ["%.3g" % e for e in errs], tol), flush=True)
    check(plain_launches == 0, "nd.%s plain run launched a kernel" % name)
    check(max(errs) <= tol, "nd.%s disagrees with its plain version" % name)
    return {"launches": launches, "rel_l2": errs, "limit": tol}


def phase_nd_ops(dev):
    """Every case of ``tools/nd_op_cases.py`` through the port's ``nd`` on
    the card and on the CPU from the same seeded numpy inputs: outputs,
    input arrays after the call (the updates' in-place states) and
    gradients, at ``card_tol`` (ten times the CPU parity tolerance; TF32
    off), and every op but the in-place ones leaves its inputs as they
    were on the card (``assert_inputs_kept``). Then the three ``nd`` ops
    that reach kernels, at a GPT-2 step's sizes, must launch their forward
    and backward kernels and agree with their plain versions on the
    card."""
    import torch
    import mxnet_tpu_torch as mx
    from tools.nd_op_cases import (CASES, assert_inputs_kept, assert_same,
                                   card_tol, run_case)

    t0 = time.perf_counter()
    ctx = mx.context.context_from_device(dev)
    failures = []
    for case in CASES:
        try:
            with mx.cpu():
                ref = run_case(mx.nd, mx.autograd, case,
                               lambda x: mx.nd.array(x, dtype=x.dtype.name))
            with ctx:
                got = run_case(mx.nd, mx.autograd, case,
                               lambda x: mx.nd.array(x, dtype=x.dtype.name))
            for g, r, what in zip(got, ref, ("output", "input after",
                                             "grad")):
                assert_same(g, r, card_tol(case), "%s %s" % (case.id, what))
            assert_inputs_kept(case, got[1])
        except Exception as e:  # every case is read before the check
            failures.append("%s: %s" % (case.id, str(e).splitlines()[0]
                                        if str(e) else type(e).__name__))
    torch.cuda.synchronize()
    print("nd ops: %d cases on the card against the CPU, %d failed%s "
          "(%.1f s)" % (len(CASES), len(failures),
                        "".join("\n  " + f for f in failures),
                        time.perf_counter() - t0), flush=True)
    check(not failures, "nd ops disagree card against CPU: %s"
          % failures[:5])
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    shapes = ND_KERNEL_SHAPES
    C = shapes["layernorm"][-1]
    x = torch.randn(*shapes["layernorm"], device=dev, generator=g)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    V = GPT_CONFIG["vocab_size"]
    logits = torch.randn(shapes["xent_rows"], V, device=dev, generator=g)
    labels = torch.randint(0, V, (shapes["xent_rows"],), device=dev,
                           generator=g, dtype=torch.int32)
    qkv = [torch.randn(*shapes["flash"], device=dev, generator=g).to(
        torch.bfloat16) for _ in range(3)]
    kernel_ops = {
        "LayerNorm": _nd_kernel_case(
            mx.nd, mx.autograd, "LayerNorm",
            lambda a, gm, b: mx.nd.LayerNorm(a, gm, b),
            [x, gamma, beta], "float32"),
        "softmax_cross_entropy": _nd_kernel_case(
            mx.nd, mx.autograd, "softmax_cross_entropy",
            lambda a, y: mx.nd.softmax_cross_entropy(a, y).reshape(1),
            [logits, labels], "float32"),
        "scaled_dot_attention": _nd_kernel_case(
            mx.nd, mx.autograd, "scaled_dot_attention",
            lambda q, k, v: mx.nd.scaled_dot_attention(q, k, v,
                                                       causal=True),
            qkv, "bfloat16")}
    want = {"LayerNorm": ("layernorm", "layernorm_bwd"),
            "softmax_cross_entropy": ("softmax_xent_fwd",
                                      "softmax_xent_bwd"),
            "scaled_dot_attention": ("flash_attention_fwd",
                                     "flash_attention_bwd")}
    for op, names in want.items():
        got = kernel_ops[op]["launches"]
        check(all(got[n] == 1 for n in names) and sum(got.values()) == 2,
              "nd.%s launched %s, not one each of %s" % (op, got, names))
    return {"cases": len(CASES), "failures": failures,
            "card_tol_factor": 10, "tf32": False,
            "kernel_ops": kernel_ops,
            "seconds": time.perf_counter() - t0}


class _UnguardedLayerNorm:
    """A planted copy of the LayerNorm Function as it was before the
    second-order guard: its backward calls the kernel whatever the grad
    mode, so under ``create_graph`` its gradient carries no graph and the
    second-order terms through it vanish without an error."""

    @staticmethod
    def make():
        import torch
        from mxnet_tpu_torch.ops.cuda import layernorm as ln

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x, gamma, beta, eps):
                ctx.save_for_backward(x, gamma)
                ctx.eps = eps
                return ln.fused_layernorm(x, gamma, beta, eps)

            @staticmethod
            def backward(ctx, dy):
                x, gamma = ctx.saved_tensors
                dx, dg, db = ln.fused_layernorm_bwd(x, gamma, dy, ctx.eps)
                return dx, dg, db, None

        return lambda x, gamma, beta, eps=1e-5: Fn.apply(x, gamma, beta, eps)


# the WGAN-GP critic: input 768, hidden 3072 (tanh), output 1, batch 64
CRITIC = {"in": 768, "hidden": 3072, "batch": 64}
# the penalty's parameter gradients, card against CPU, relative L2 (fp32,
# TF32 off: products of length 768 and 3072 summed in another order)
CRITIC_TOL = 1e-4


def _critic(dev, with_ln, seed):
    import torch
    from mxnet_tpu_torch import gluon

    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(CRITIC["hidden"], in_units=CRITIC["in"]))
    if with_ln:
        net.add(gluon.nn.LayerNorm(in_channels=CRITIC["hidden"]))
    net.add(gluon.nn.Activation("tanh"))
    net.add(gluon.nn.Dense(1, in_units=CRITIC["hidden"]))
    net.initialize(device=dev,
                   generator=torch.Generator(device=dev).manual_seed(seed))
    return net


def _penalty_grads(net, xnp, ctx):
    """The gradient penalty ((|dD/dx| - 1)^2).mean() of critic ``net`` at
    ``xnp``, through ``autograd.grad(create_graph=True)``, and its
    gradients with respect to the critic's parameters."""
    from mxnet_tpu_torch import autograd, nd

    x = nd.array(xnp, ctx=ctx)
    with autograd.record():
        out = net(x)
        (gx,) = autograd.grad(out.sum(), [x], create_graph=True)
        norm = nd.sqrt((gx * gx).sum(axis=1))
        pen = ((norm - 1.0) * (norm - 1.0)).mean()
    pen.backward()
    return float(pen.asscalar()), [p._tensor().grad.detach().float().cpu()
                                   for p in net.collect_params().values()]


def _copy_to_cpu(net_card, net_cpu):
    for a, b in zip(net_card.collect_params().values(),
                    net_cpu.collect_params().values()):
        b.set_data(a._tensor().detach().cpu())


def phase_create_graph(dev):
    """``autograd.grad(create_graph=True)`` on the card: the WGAN-GP
    critic's penalty gradients against the same on the CPU (``CRITIC_TOL``);
    the same through ``nd.LayerNorm`` must raise ``SecondOrderError``; and
    a planted copy of the unguarded LayerNorm Function gives penalty
    gradients that the tolerance catches (the fault this guard repairs)."""
    import torch
    from mxnet_tpu_torch import ops
    from mxnet_tpu_torch.context import context_from_device, cpu
    from mxnet_tpu_torch.ops.cuda import SecondOrderError

    ctx = context_from_device(dev)
    xnp = np.random.RandomState(SEED + 31).randn(
        CRITIC["batch"], CRITIC["in"]).astype(np.float32)

    def card_and_cpu(with_ln):
        card = _critic(dev, with_ln, SEED + 32)
        host = _critic(torch.device("cpu"), with_ln, SEED + 32)
        _copy_to_cpu(card, host)
        return card, host

    card, host = card_and_cpu(False)
    pen_card, g_card = _penalty_grads(card, xnp, ctx)
    pen_cpu, g_cpu = _penalty_grads(host, xnp, cpu())
    errs = [_rel(a, b) for a, b in zip(g_card, g_cpu)]
    print("create_graph: WGAN-GP penalty %.6f on the card, %.6f on the CPU; "
          "parameter gradients relative L2 %s (limit %g)"
          % (pen_card, pen_cpu, ["%.3g" % e for e in errs], CRITIC_TOL),
          flush=True)
    check(max(errs) <= CRITIC_TOL, "create_graph: the card's penalty "
          "gradients disagree with the CPU's")
    # dD/dx does not depend on the output bias: its gradient is zero
    check(all(bool(g.abs().sum() > 0) for g in g_card[:-1]),
          "create_graph: a zero penalty gradient")

    card, host = card_and_cpu(True)
    raised = None
    try:
        _penalty_grads(card, xnp, ctx)
    except SecondOrderError as e:
        raised = str(e)
    print("create_graph through nd.LayerNorm on the card: %s"
          % (raised or "no error"), flush=True)
    check(raised is not None and "layernorm_bwd" in raised,
          "create_graph through the LayerNorm kernel did not raise")
    _, g_cpu = _penalty_grads(host, xnp, cpu())
    saved = ops.functional.layernorm
    ops.functional.layernorm = _UnguardedLayerNorm.make()
    try:
        for p in card.collect_params().values():
            p.zero_grad()
        _, g_planted = _penalty_grads(card, xnp, ctx)
    finally:
        ops.functional.layernorm = saved
    planted = [_rel(a, b) for a, b in zip(g_planted, g_cpu)]
    print("create_graph, planted unguarded LayerNorm: parameter gradients "
          "relative L2 against the CPU %s (limit %g: must read above it)"
          % (["%.3g" % e for e in planted], CRITIC_TOL), flush=True)
    check(max(planted) > CRITIC_TOL, "the planted unguarded LayerNorm's "
          "second order went unseen")
    return {"penalty": [pen_card, pen_cpu], "rel_l2": errs,
            "limit": CRITIC_TOL, "layernorm_raised": raised,
            "planted_rel_l2": planted}


# ------------------------------------------------ A.11: LSTM PTB, SSD-512 and
# Transformer NMT at bench.py's recipes
LSTM_RECIPE = {"vocab": 10000, "batch": 32, "bptt": 35}
NMT_RECIPE = {"vocab": 32000, "batch": 32, "src_len": 64, "tgt_len": 64,
              "max_len": 128}
SSD_RECIPE = {"batch": 32, "size": 512, "boxes": 8, "classes": 20}
# BASELINE.md's MXNet figures on an A100, printed beside the card's as
# context only
A11_BASELINE = {"lstm": (45000.0, "tokens/s"), "ssd512": (230.0, "images/s"),
                "nmt": (110000.0, "tokens/s")}
A11_STEPS = 3          # the LSTM and NMT main paths
A11_TIMED = 5
SSD_STEPS = 10         # the SSD main path: steps on one fixed batch
# kernel launches a step: the LSTM's loss is one softmax-xent over its
# (1120, 10000) logits each way; the NMT's 12 encoder and 18 decoder
# LayerNorms each way and one softmax-xent over (2048, 32000); attention
# at 64 tokens is the dense path (under FLASH_MIN_LEN), so no flash
LSTM_STEP_LAUNCHES = {"softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
NMT_STEP_LAUNCHES = {"layernorm": 30, "layernorm_bwd": 30,
                     "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
NMT_ENCODE_LN = 12
NMT_DECODE_LN = 18     # 3 a decoder layer, each cached decode step
# a step with the kernels against the same step with the plain versions:
# GPT-2's limits (the loss STEP_LOSS_TOL, each gradient 2e-2 relative L2
# as BERT's, the worst row 0.3)
A11_GRAD_TOL = STEP_GRAD_TOL
A11_ROW_TOL = GPT_STEP_ROW_TOL
# the LSTM evaluation idiom in fp32: 4 chunks of bptt tokens with the
# states carried against one forward over the 140 (GEMMs of other heights
# may sum in other orders), and the card against the CPU
LSTM_INFER_CHUNKS = 4
LSTM_CHUNKED_TOL = 1e-5
LSTM_CPU_TOL = 1e-4
# SSD at batch 2 in fp32, the card against the CPU (the zoo's limits)
SSD_CPU_BATCH = 2
SSD_CPU_LOSS_TOL = 1e-3
SSD_CPU_GRAD_TOL = 2e-2
SSD_DETECT_BATCH = 8
NMS_IOU_EDGE = 1e-6
NMT_TRANSLATE = {"batch": 8, "max_len": 64, "beam": 4}
# fp32 greedy decoding over the cache against re-forward: equal tokens;
# a parting is allowed only where the re-forward's own top two logits are
# closer than this (two fp32 sums in other orders), and is counted
NMT_FP32_TIE = 1e-4


class lstm_gates_swapped:
    """A planted fault: within the block the fused LSTM step takes its
    forget gate for the input gate and the input gate for the forget
    gate."""

    def __enter__(self):
        from mxnet_tpu_torch.ops import rnn

        self.real = real = rnn._lstm_step

        def swapped(h, c, xw, whh_t, bhh):
            import torch

            i, f, g, o = xw.chunk(4, dim=-1)
            xs = torch.cat([f, i, g, o], dim=-1)
            w = whh_t.chunk(4, dim=-1)
            b = bhh.chunk(4, dim=-1)
            return real(h, c, xs, torch.cat([w[1], w[0], w[2], w[3]], -1),
                        torch.cat([b[1], b[0], b[2], b[3]], -1))

        rnn._lstm_step = swapped
        return self

    def __exit__(self, *exc):
        from mxnet_tpu_torch.ops import rnn

        rnn._lstm_step = self.real


# faults planted into a plain-version step: (wrappers replaced, a patch of
# the model code); the limits must catch each, and pass the plain step run
# again. At vocabularies of 10000 and 32000 bf16 every logits row is whole
# 16-byte vectors, so the unaligned-tail fault would change nothing: the
# last 8 columns of dx are dropped instead
_XENT_LAST_COLUMNS = ({"softmax_xent_bwd": xent_dx_last_columns_dropped},
                      contextlib.nullcontext)
LSTM_FAULTS = {
    "LSTM forget and input gates swapped": ({}, lstm_gates_swapped),
    "softmax-xent dx drops each row's last 8 columns": _XENT_LAST_COLUMNS,
    "none (the plain step again)": ({}, contextlib.nullcontext),
}
NMT_FAULTS = {
    "LayerNorm gamma 1% high": ({"fused_layernorm": layernorm_gamma_high},
                                contextlib.nullcontext),
    "softmax-xent dx drops each row's last 8 columns": _XENT_LAST_COLUMNS,
    "none (the plain step again)": ({}, contextlib.nullcontext),
}


class LMTrainStep:
    """A language-model step of ``bench.py``'s ``lstm`` or ``nmt`` recipe
    through the port's entry points: the model from the seed in bf16 via
    amp, ``autograd.record``, the mean of ``F.softmax_xent_rows`` over the
    logits (bench.py's ``_xent_mean``), ``autograd.backward`` and
    ``gluon.Trainer`` with fp32 masters, on one batch from the seed.
    Dropout draws from ``mxnet_tpu_torch.random``'s generator of the
    card."""

    timed = TrainStep.timed

    def __init__(self, dev, kind, dtype="bfloat16"):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.models.lstm_lm import lstm_ptb
        from mxnet_tpu_torch.models.transformer import transformer_base

        self.kind = kind
        rng = np.random.default_rng(SEED)
        if kind == "lstm":
            r = LSTM_RECIPE
            self.model = lstm_ptb(vocab_size=r["vocab"], tie_weights=True,
                                  dropout=0.5)
            shape = (r["bptt"], r["batch"])
            self.inputs = [rng.integers(0, r["vocab"], shape)]
            self.labels = rng.integers(0, r["vocab"], shape)
            opt, kw = "sgd", {"learning_rate": 1.0}
        else:
            r = NMT_RECIPE
            self.model = transformer_base(r["vocab"], r["vocab"],
                                          max_len=r["max_len"], dropout=0.1)
            self.inputs = [rng.integers(4, r["vocab"], (r["batch"], n))
                           for n in (r["src_len"], r["tgt_len"])]
            self.labels = rng.integers(4, r["vocab"],
                                       (r["batch"], r["tgt_len"]))
            opt, kw = "adam", {"learning_rate": 1e-4}
        self.model.initialize(
            device=dev,
            generator=torch.Generator(device=dev).manual_seed(SEED))
        if dtype == "bfloat16":
            amp.convert_hybrid_block(self.model, "bfloat16")
            kw["multi_precision"] = True
        self.params = [p for p in self.model.collect_params().values()
                       if p.grad_req != "null"]
        self.trainer = gluon.Trainer(self.model.collect_params(), opt, kw)
        self.inputs = [torch.from_numpy(a.astype(np.int32)).to(dev)
                       for a in self.inputs]
        self.labels = torch.from_numpy(self.labels.astype(np.int32)).to(dev)
        self.tokens = self.labels.numel()

    def __call__(self, update=True):
        """One step; returns the loss (1,)."""
        from mxnet_tpu_torch import autograd
        from mxnet_tpu_torch.ops import F

        with autograd.record():
            loss = F.softmax_xent_rows(self.model(*self.inputs),
                                       self.labels).mean()
        autograd.backward(loss)
        if update:
            self.trainer.step(1)
        return loss.detach().reshape(1)


def step_against_plain(step, faults, what, hold=True):
    """One step with the kernels against the same step with the plain
    versions (no kernel may launch in it), from the same weights and
    dropout draws: the loss, each gradient's and its worst row's relative
    L2 (the attention key biases left out); then the plain step with each
    of ``faults``, which the limits must catch (and pass the plain step
    run again). With ``hold=False`` the readings are printed and returned
    and nothing is checked (``faults`` may then name kernels kept in the
    plain step, to read each one's share). Returns (reading, the faults'
    readings)."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    mx_random.seed(SEED)
    loss_k = step(update=False).float()
    grads_k = _grads(step.params)
    for p, gk in zip(step.params, grads_k):
        check(bool(torch.isfinite(gk).all()), "%s %s: non-finite grad"
              % (what, p.name))
    mx_random.seed(SEED)
    reset_counters()
    with plain_versions():
        loss_p = step(update=False).float()
    check(not any(read_counters().values()),
          "the plain-version %s step launched a kernel: %s"
          % (what, read_counters()))
    grads_p = _grads(step.params)

    # the attention key biases' gradients are 0 up to rounding (a softmax
    # does not move under a shift of its logits), so their relative L2 is
    # noise over noise: they are left out
    held_ = [i for i, p in enumerate(step.params)
             if not p.name.endswith("key_bias")]
    params = [step.params[i] for i in held_]

    def reading(loss, grads):
        grads = [grads[i] for i in held_]
        ref = [grads_p[i] for i in held_]
        return {"loss_err": float((loss.mean() - loss_p.mean()).abs()),
                "worst_grad_rel_l2": [[r, n] for r, n in grad_rel_l2(
                    params, grads, ref)[:3]],
                "worst_row_rel_l2": [[r, n] for r, n in grad_row_rel_l2(
                    params, grads, ref)[:3]],
                "held_params": len(params)}

    def within(r):
        return (r["loss_err"] <= STEP_LOSS_TOL
                and r["worst_grad_rel_l2"][0][0] <= A11_GRAD_TOL
                and r["worst_row_rel_l2"][0][0] <= A11_ROW_TOL)

    def show(r):
        return ("loss |diff| %.3g, worst gradient relative L2 %s, worst row "
                "%s" % (r["loss_err"], ["%.3g %s" % tuple(x) for x in
                                        r["worst_grad_rel_l2"]],
                        ["%.3g %s" % tuple(x) for x in
                         r["worst_row_rel_l2"]]))

    honest = reading(loss_k, grads_k)
    honest["loss"] = [float(loss_k.mean()), float(loss_p.mean())]
    del grads_k
    print("%s step with kernels vs plain versions: %s (limits %g, %g, %g%s)"
          % (what, show(honest), STEP_LOSS_TOL, A11_GRAD_TOL, A11_ROW_TOL,
             "" if hold else "; a reading, not held"), flush=True)
    out = {}
    check(within(honest) or not hold,
          "%s step disagrees with the plain versions: %s" % (what, honest))
    for name, (override, patch) in faults.items():
        mx_random.seed(SEED)
        with plain_versions(**override), patch():
            loss_f = step(update=False).float()
        out[name] = reading(loss_f, _grads(step.params))
        out[name]["caught"] = not within(out[name])
        planted = bool(override) or patch is not contextlib.nullcontext
        print("%s step, %s %r vs plain versions: %s; outside the limits %s"
              % (what, "planted fault" if hold else "with", name,
                 show(out[name]), out[name]["caught"]), flush=True)
        check(out[name]["caught"] == planted or not hold,
              "the %s step's limits %s %r"
              % (what, "miss the planted fault" if planted else "refuse",
                 name))
    return honest, out


def lm_main_path(step, what, want):
    """``A11_STEPS`` steps with every counter at 0 just before them:
    finite losses, weights that move, the launches ``want`` a step and no
    other kernel. Returns (losses, launches)."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    watch = [step.params[0], step.params[-1]]
    before = [p._tensor().detach().clone() for p in watch]
    mx_random.seed(SEED)
    reset_counters()
    losses = [float(step().mean()) for _ in range(A11_STEPS)]
    torch.cuda.synchronize()
    launches = read_counters()
    print("%s train losses %s; kernel launches in %d steps: %s"
          % (what, ["%.4f" % x for x in losses], A11_STEPS,
             {k: v for k, v in launches.items() if v}), flush=True)
    check(all(np.isfinite(losses)), "non-finite %s training loss" % what)
    for p, b in zip(watch, before):
        check(not torch.equal(p._tensor(), b), "%s: %s did not move"
              % (what, p.name))
    for name, n in launches.items():
        check(n == want.get(name, 0) * A11_STEPS,
              "%s %s launches %d != %d x %d steps"
              % (what, name, n, want.get(name, 0), A11_STEPS))
    return losses, launches


def lm_step_timing(step, what, tokens, baseline):
    """The step's median wall over ``A11_TIMED`` steps by CUDA events and
    by the host, tokens/s, peak memory, beside BASELINE.md's A100
    figure."""
    import torch

    step()
    dev_ms, host_ms = device_step_ms(step, A11_TIMED)
    out = {"step_device_ms_median": dev_ms, "step_wall_ms_median": host_ms,
           "tokens_per_s": tokens / host_ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "baseline_a100": baseline}
    print("%s train step: median %.3f ms by CUDA events, %.3f ms host wall "
          "over %d steps; %.1f tokens/s (BASELINE.md's MXNet on an A100: "
          "%g %s, context only); peak memory %.2f GB"
          % (what, dev_ms, host_ms, A11_TIMED, out["tokens_per_s"],
             baseline[0], baseline[1], out["peak_memory_gb"]), flush=True)
    return out


def phase_lstm_train(dev):
    """``bench.py``'s ``lstm`` recipe: ``lstm_ptb(10000, tie_weights=True,
    dropout=0.5)`` in bf16, SGD lr 1.0 with fp32 masters, batch 32 x bptt
    35: the main path (exact launches), one step against the plain
    versions with planted faults, the step's wall, and the recurrence
    alone (the port's ``F.RNN``) against cuDNN's bf16 ``nn.LSTM`` at the
    same shapes, forward and forward + backward."""
    import torch

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step = LMTrainStep(dev, "lstm")
    print("lstm train step: %d parameters, batch %d x bptt %d, vocab %d; "
          "set-up %.2f s" % (sum(p._tensor().numel() for p in step.params),
                             LSTM_RECIPE["batch"], LSTM_RECIPE["bptt"],
                             LSTM_RECIPE["vocab"],
                             time.perf_counter() - t0), flush=True)
    losses, launches = lm_main_path(step, "lstm", LSTM_STEP_LAUNCHES)
    honest, faults = step_against_plain(step, LSTM_FAULTS, "lstm")
    out = {"recipe": dict(LSTM_RECIPE, hidden=650, layers=2, dropout=0.5,
                          tied=True, optimizer="sgd lr 1.0"),
           "losses": losses, "launches": launches,
           "steps_counted": A11_STEPS, "vs_plain": honest,
           "planted_faults": faults}
    out.update(lm_step_timing(step, "lstm", step.tokens,
                              A11_BASELINE["lstm"]))
    out["recurrence"] = lstm_recurrence_timing(dev, step.model)
    return step, out


def lstm_recurrence_timing(dev, model):
    """The port's fused LSTM (``F.RNN``, the step's two layers in bf16
    with fp32 c0) against cuDNN's bf16 ``nn.LSTM`` at (35, 32, 650) x 2
    layers: median ms of 5 calls by CUDA events, forward and forward +
    backward (every call eager: the port's recurrence is a loop of
    launches). cuDNN rounds c to bf16 each step and is not the port's
    function: a yardstick only."""
    import torch
    from mxnet_tpu_torch.ops import F

    T, N, H = LSTM_RECIPE["bptt"], LSTM_RECIPE["batch"], model._num_hidden
    L = model.rnn._num_layers
    g = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn(T, N, H, device=dev, generator=g).to(torch.bfloat16)
    dout = torch.randn(T, N, H, device=dev, generator=g).to(torch.bfloat16)
    weights = [getattr(model.rnn, n)._tensor().detach().clone()
               .requires_grad_() for n in model.rnn._weight_names()]
    zeros = torch.zeros(L, N, H, device=dev)
    xg = x.clone().requires_grad_()

    def port_fwd():
        with torch.no_grad():
            return F.RNN(x, zeros, zeros, *weights, num_layers=L)[0]

    def port_both():
        out = F.RNN(xg, zeros, zeros, *weights, num_layers=L)[0]
        return torch.autograd.grad(out, [xg] + weights, dout)

    lstm = torch.nn.LSTM(H, H, L).to(device=dev, dtype=torch.bfloat16)

    def cudnn_fwd():
        with torch.no_grad():
            return lstm(x)[0]

    def cudnn_both():
        out = lstm(xg)[0]
        return torch.autograd.grad(out, [xg] + list(lstm.parameters()),
                                   dout)

    def events(fn, n=5):
        fn()
        ts = []
        for _ in range(n):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            ts.append(s.elapsed_time(e))
        return float(np.median(ts))

    out = {"shape": [T, N, H], "layers": L,
           "port_fwd_ms": events(port_fwd), "port_fwd_bwd_ms":
           events(port_both), "cudnn_fwd_ms": events(cudnn_fwd),
           "cudnn_fwd_bwd_ms": events(cudnn_both)}
    print("lstm recurrence at %s x %d layers bf16: the port's F.RNN %.3f "
          "ms forward, %.3f ms forward + backward; cuDNN nn.LSTM %.3f ms, "
          "%.3f ms (CUDA events, eager)" % (
              out["shape"], L, out["port_fwd_ms"], out["port_fwd_bwd_ms"],
              out["cudnn_fwd_ms"], out["cudnn_fwd_bwd_ms"]), flush=True)
    return out


def phase_lstm_infer(dev):
    """The PTB evaluation idiom in predict mode, fp32: ``begin_state``,
    then ``LSTM_INFER_CHUNKS`` consecutive chunks of bptt tokens with the
    states carried, against one forward over the whole sequence on the
    card, and against the same chunks on the CPU; the chunked pass's
    tokens/s."""
    import torch
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.models.lstm_lm import lstm_ptb

    r = LSTM_RECIPE
    T, N = r["bptt"], r["batch"]
    model = lstm_ptb(vocab_size=r["vocab"], tie_weights=True, dropout=0.5)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 3))
    tok = np.random.default_rng(SEED + 3).integers(
        0, r["vocab"], (LSTM_INFER_CHUNKS * T, N)).astype(np.int32)

    def chunked(m, device):
        x = torch.from_numpy(tok).to(device)
        states = m.begin_state(N, ctx=mx.context.context_from_device(
            torch.device(device)))
        outs = []
        for i in range(LSTM_INFER_CHUNKS):
            y, states = m(x[i * T:(i + 1) * T], states)
            outs.append(y._data if isinstance(y, mx.NDArray) else y)
        return torch.cat(outs)

    reset_counters()
    with torch.no_grad():
        t0 = time.perf_counter()
        got = chunked(model, dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = chunked(model, dev)
        torch.cuda.synchronize()
        wall = min(wall, time.perf_counter() - t0)
        whole = model(torch.from_numpy(tok).to(dev))
    launches = read_counters()
    cpu = lstm_ptb(vocab_size=r["vocab"], tie_weights=True, dropout=0.5)
    cpu.initialize(device="cpu")
    _copy_to_cpu(model, cpu)
    with torch.no_grad():
        ref = chunked(cpu, "cpu")
    out = {"chunks": LSTM_INFER_CHUNKS, "tokens": int(tok.size),
           "chunked_vs_whole_rel_l2": _rel(got, whole),
           "card_vs_cpu_rel_l2": _rel(got.cpu(), ref),
           "launches": launches, "wall_ms": wall * 1e3,
           "tokens_per_s": tok.size / wall}
    print("lstm evaluation, %d chunks of %d x %d fp32 with the states "
          "carried: against one forward over %d tokens relative L2 %.3g "
          "(limit %g), against the CPU %.3g (limit %g); %.1f ms, %.1f "
          "tokens/s" % (LSTM_INFER_CHUNKS, T, N, LSTM_INFER_CHUNKS * T,
                        out["chunked_vs_whole_rel_l2"], LSTM_CHUNKED_TOL,
                        out["card_vs_cpu_rel_l2"], LSTM_CPU_TOL,
                        out["wall_ms"], out["tokens_per_s"]), flush=True)
    check(bool(torch.isfinite(got).all()) and tuple(got.shape) == (
        LSTM_INFER_CHUNKS * T, N, r["vocab"]), "lstm evaluation output")
    check(out["chunked_vs_whole_rel_l2"] <= LSTM_CHUNKED_TOL,
          "lstm chunked evaluation differs from one forward")
    check(out["card_vs_cpu_rel_l2"] <= LSTM_CPU_TOL,
          "lstm evaluation on the card differs from the CPU")
    check(not any(launches.values()), "lstm evaluation launched %s"
          % launches)
    return out


class SSDTrainStep:
    """``bench.py``'s ``ssd512`` recipe through the port's entry points:
    ``ssd_512(num_classes=20)`` from the seed, one forward of a zero
    (1, 3, 512, 512) batch to shape the deferred parameters, amp bf16 (or
    fp32), ``SSDLoss(20)`` on the fp32 predictions, the mean over the
    images, SGD lr 1e-3 momentum 0.9 wd 5e-4 with fp32 masters, on one
    fixed batch of ``batch`` images of 512 x 512 with 8 boxes each."""

    timed = TrainStep.timed

    def __init__(self, dev, batch=SSD_RECIPE["batch"], dtype="bfloat16"):
        import torch
        from mxnet_tpu_torch import amp, gluon
        from mxnet_tpu_torch.models.ssd import SSDLoss, ssd_512

        S, C = SSD_RECIPE["size"], SSD_RECIPE["classes"]
        self.net = ssd_512(num_classes=C)
        self.net.initialize(device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        with torch.no_grad():
            self.net(torch.zeros(1, 3, S, S, device=dev))
        self.dtype = getattr(torch, dtype)
        if dtype == "bfloat16":
            amp.convert_hybrid_block(self.net, "bfloat16")
        self.loss_blk = SSDLoss(C)
        self.params = [p for p in self.net.collect_params().values()
                       if p.grad_req != "null"]
        self.trainer = gluon.Trainer(
            self.net.collect_params(), "sgd",
            {"learning_rate": 1e-3, "momentum": 0.9, "wd": 5e-4,
             "multi_precision": dtype == "bfloat16"})
        rng = np.random.default_rng(SEED)
        B, M = batch, SSD_RECIPE["boxes"]
        x = rng.normal(size=(B, 3, S, S)).astype(np.float32)
        cls = rng.integers(0, C, (B, M, 1)).astype(np.float32)
        lo = rng.uniform(0.0, 0.7, (B, M, 2)).astype(np.float32)
        wh = rng.uniform(0.1, 0.3, (B, M, 2)).astype(np.float32)
        labels = np.concatenate([cls, lo, np.minimum(lo + wh, 1.0)], -1)
        self.x = torch.from_numpy(x).to(dev)
        self.labels = torch.from_numpy(labels).to(dev)

    def loss(self):
        cls_preds, box_preds, anchors = self.net(self.x.to(self.dtype))
        return self.loss_blk(cls_preds.float(), box_preds.float(),
                             self.labels, anchors).mean()

    def __call__(self, update=True):
        from mxnet_tpu_torch import autograd

        with autograd.record():
            loss = self.loss()
        autograd.backward(loss)
        if update:
            self.trainer.step(1)
        return loss.detach().reshape(1)


def phase_ssd_train(dev):
    """``bench.py``'s ``ssd512`` recipe on the card: ``SSD_STEPS`` steps on
    one fixed batch of 32 (the loss falls, no kernel launches), the step's
    wall by CUDA events and by the host, images/s and peak memory; then at
    batch 2 in fp32 one step on the card against the same step on the CPU
    from the same weights: the loss and every gradient."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step = SSDTrainStep(dev)
    B = SSD_RECIPE["batch"]
    torch.cuda.synchronize()
    print("ssd512 train step: %d trained parameters, batch %d at 512x512, "
          "%d boxes an image, bf16; set-up %.2f s"
          % (sum(p._tensor().numel() for p in step.params), B,
             SSD_RECIPE["boxes"], time.perf_counter() - t0), flush=True)
    # a box head whose scale matches no box has no gradient but its weight
    # decay: watch the base and the first class head
    watch = [step.params[0], step.net.cls_heads[0].weight]
    before = [p._tensor().detach().clone() for p in watch]
    mx_random.seed(SEED)
    reset_counters()
    t0 = time.perf_counter()
    losses = [float(step().mean()) for _ in range(SSD_STEPS)]
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = read_counters()
    print("ssd512 losses over %d steps on one batch: %s; kernel launches: "
          "%s (%.2f s)" % (SSD_STEPS, ["%.4f" % v for v in losses],
                           {k: v for k, v in launches.items() if v},
                           main_s), flush=True)
    check(all(np.isfinite(losses)), "non-finite ssd512 loss")
    check(losses[-1] < losses[0], "the ssd512 loss did not fall: %s"
          % losses)
    for p, b in zip(watch, before):
        check(not torch.equal(p._tensor(), b), "ssd512: %s did not move"
              % p.name)
    check(not any(launches.values()), "the ssd512 step launched %s"
          % launches)
    dev_ms, host_ms = device_step_ms(step, A11_TIMED)
    out = {"recipe": dict(SSD_RECIPE, optimizer="sgd lr 1e-3 momentum 0.9 "
                          "wd 5e-4"),
           "losses": losses, "launches": launches, "steps_counted": SSD_STEPS,
           "step_device_ms_median": dev_ms, "step_wall_ms_median": host_ms,
           "images_per_s": B / host_ms * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "baseline_a100": A11_BASELINE["ssd512"]}
    print("ssd512 train step: median %.3f ms by CUDA events, %.3f ms host "
          "wall over %d steps; %.1f images/s (BASELINE.md's MXNet on an "
          "A100: %g images/s, context only); peak memory %.2f GB"
          % (dev_ms, host_ms, A11_TIMED, out["images_per_s"],
             A11_BASELINE["ssd512"][0], out["peak_memory_gb"]), flush=True)
    out["vs_cpu"] = ssd_against_cpu(dev)
    return step, out


def ssd_against_cpu(dev):
    """One fp32 SSD step at batch 2 on the card and on the CPU from the
    same weights and images: the loss within ``SSD_CPU_LOSS_TOL`` and
    every gradient within ``SSD_CPU_GRAD_TOL`` relative L2."""
    import torch

    card = SSDTrainStep(dev, batch=SSD_CPU_BATCH, dtype="float32")
    cpu = SSDTrainStep(torch.device("cpu"), batch=SSD_CPU_BATCH,
                       dtype="float32")
    _copy_to_cpu(card.net, cpu.net)
    loss_c = float(card(update=False).mean())
    t0 = time.perf_counter()
    loss_r = float(cpu(update=False).mean())
    cpu_s = time.perf_counter() - t0
    rel = grad_rel_l2(card.params, [g.cpu() for g in _grads(card.params)],
                      _grads(cpu.params))
    out = {"batch": SSD_CPU_BATCH, "loss": [loss_c, loss_r],
           "loss_err": abs(loss_c - loss_r),
           "worst_grad_rel_l2": [list(r) for r in rel[:3]],
           "cpu_step_s": cpu_s}
    print("ssd512 fp32 batch %d, card against CPU: loss %.6f vs %.6f "
          "(|diff| %.3g, limit %g); worst gradient relative L2 %s (limit "
          "%g); the CPU step %.1f s" % (
              SSD_CPU_BATCH, loss_c, loss_r, out["loss_err"],
              SSD_CPU_LOSS_TOL, ["%.3g %s" % tuple(r) for r in rel[:3]],
              SSD_CPU_GRAD_TOL, cpu_s), flush=True)
    check(out["loss_err"] <= SSD_CPU_LOSS_TOL,
          "ssd512 loss on the card differs from the CPU")
    check(rel[0][0] <= SSD_CPU_GRAD_TOL,
          "ssd512 gradients on the card differ from the CPU")
    return out


def nms_deciding_iou(det, keep_ref, i, thresh):
    """The largest IoU between entry ``i`` and the entries of its class
    that score above it and that the reference keeps: what decides
    whether ``i`` is suppressed."""
    import torch
    from mxnet_tpu_torch.ops.detection import _iou_corner

    s = det[:, 1]
    above = keep_ref & (det[:, 0] == det[i, 0]) & (
        (s > s[i]) | ((s == s[i]) & (torch.arange(len(s)) < i)))
    if not bool(above.any()):
        return None
    return float(_iou_corner(det[i:i + 1, 2:6], det[above, 2:6]).max())


def phase_ssd_detect(dev, net):
    """``detect`` at batch 8 on the trained SSD: the detections' shape and
    values; on the same decoded boxes and scores the card's ``box_nms``
    keeps the same entries as the CPU's, apart from entries whose
    deciding IoU lies within ``NMS_IOU_EDGE`` of the threshold (counted);
    the NMS loop's time by CUDA events and ``detect``'s wall."""
    import torch
    from mxnet_tpu_torch.ops import F
    from mxnet_tpu_torch.ops import detection

    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    S, B = SSD_RECIPE["size"], SSD_DETECT_BATCH
    x = torch.randn(B, 3, S, S, device=dev, generator=g)
    thresh = 0.45
    with torch.no_grad():
        cls_preds, box_preds, anchors = net(x.to(torch.bfloat16))
        prob = F.softmax(cls_preds, axis=-1).transpose(1, 2)
        decoded = detection.decode_detections(prob, box_preds, anchors,
                                              threshold=0.01)
    n = anchors.shape[1]
    torch.cuda.synchronize()
    reset_counters()
    t0 = time.perf_counter()
    det = net.detect(x.to(torch.bfloat16), nms_thresh=thresh,
                     score_thresh=0.01, device=dev)
    torch.cuda.synchronize()
    detect_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    check(tuple(det.shape) == (B, n, 6), "detect shape %s"
          % (tuple(det.shape),))
    check(bool(torch.isfinite(det).all()), "non-finite detections")
    kept_card = detection.box_nms(decoded, overlap_thresh=thresh,
                                  valid_thresh=0.01)[..., 1] > -1
    cpu_dec = decoded.float().cpu()
    kept_cpu = detection.box_nms(cpu_dec, overlap_thresh=thresh,
                                 valid_thresh=0.01)[..., 1] > -1
    kept_card = kept_card.cpu()
    differ = (kept_card != kept_cpu).nonzero().tolist()
    edge, far = 0, []
    for b, i in differ:
        iou = nms_deciding_iou(cpu_dec[b], kept_cpu[b], i, thresh)
        if iou is not None and abs(iou - thresh) <= NMS_IOU_EDGE:
            edge += 1
        else:
            far.append((b, i, iou))

    def nms():
        return detection.box_nms(decoded, overlap_thresh=thresh,
                                 valid_thresh=0.01)

    nms()
    ts = []
    for _ in range(3):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        nms()
        e.record()
        torch.cuda.synchronize()
        ts.append(s.elapsed_time(e))
    out = {"batch": B, "anchors": n, "kept": int(kept_card.sum()),
           "valid": int((decoded[..., 1] > 0.01).sum()),
           "differ_from_cpu": len(differ), "differ_at_edge": edge,
           "nms_ms": float(np.median(ts)), "detect_wall_ms": detect_ms,
           "launches": launches}
    print("ssd512 detect at batch %d: %d of %d valid entries kept; card vs "
          "CPU box_nms on the same boxes: %d entries differ, %d of them "
          "with the deciding IoU within %g of %g; the NMS loop %.2f ms "
          "(%d steps, CUDA events), detect %.1f ms host wall"
          % (B, out["kept"], out["valid"], len(differ), edge, NMS_IOU_EDGE,
             thresh, out["nms_ms"], n, detect_ms), flush=True)
    check(not far, "card and CPU NMS keep other entries: %s" % far[:5])
    check(not any(launches.values()), "detect launched %s" % launches)
    check(out["kept"] > 0, "detect kept nothing")
    return out


def phase_nmt_train(dev):
    """``bench.py``'s ``nmt`` recipe: ``transformer_base(32000, 32000,
    max_len=128, dropout=0.1)`` in bf16, Adam lr 1e-4 with fp32 masters,
    batch 32 of 64 + 64 tokens: the main path (exact launches: 30
    LayerNorm each way, 1 + 1 softmax-xent, no flash), one bf16 step
    against the plain versions (read), the same step in fp32 against the
    plain versions with planted faults (held), the step's wall."""
    import torch
    from mxnet_tpu_torch.ops.cuda import layernorm as ln

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    step = LMTrainStep(dev, "nmt")
    r = NMT_RECIPE
    print("nmt train step: %d parameters, batch %d, %d + %d tokens, vocab "
          "%d; set-up %.2f s" % (
              sum(p._tensor().numel() for p in step.params), r["batch"],
              r["src_len"], r["tgt_len"], r["vocab"],
              time.perf_counter() - t0), flush=True)
    losses, launches = lm_main_path(step, "nmt", NMT_STEP_LAUNCHES)
    # in bf16 the step is read, not held: each of the 30 LayerNorms
    # rounds its output to bf16 (the kernel's and the plain version's
    # roundings part by an ulp here and there), and at the random start
    # the attention's softmax backward cancels (near-uniform weights), so
    # the query and key weights' gradients move 8-17% and rows of a ReLU
    # FFN's weight far more. The plain step with one LayerNorm kernel kept
    # reads each one's share (the forward's all of it, the backward's
    # 1e-2). The same kernels in their fp32 forms are held at the same
    # shapes
    bf16, shares = step_against_plain(step, {
        "the LayerNorm forward kernel": (
            {"fused_layernorm": ln.IMPLS["fused_layernorm"]},
            contextlib.nullcontext),
        "the LayerNorm backward kernel": (
            {"fused_layernorm_bwd": ln.IMPLS["fused_layernorm_bwd"]},
            contextlib.nullcontext)}, "nmt bf16", hold=False)
    bf16["one_kernel_kept"] = shares
    fp32_step = LMTrainStep(dev, "nmt", dtype="float32")
    honest, faults = step_against_plain(fp32_step, NMT_FAULTS, "nmt fp32")
    del fp32_step
    out = {"recipe": dict(r, units=512, layers="6+6", dropout=0.1,
                          optimizer="adam lr 1e-4"),
           "losses": losses, "launches": launches,
           "steps_counted": A11_STEPS, "vs_plain": honest,
           "vs_plain_bf16": bf16, "planted_faults": faults}
    # tokens/s counts source and target tokens, as bench.py's nmt mode
    out.update(lm_step_timing(step, "nmt", r["batch"] * (
        r["src_len"] + r["tgt_len"]), A11_BASELINE["nmt"]))
    return step, out


def _greedy_parting(model, src, got, ref, tol, what):
    """(rows compared, partings, their margins): each row of ``got`` (the
    cached decode) equal to ``ref`` (re-forward) up to a step where the
    re-forward's logit of its own token leads the cached token's by less
    than ``tol``; that row is not compared after it."""
    import torch

    partings = []
    n = min(got.shape[1], ref.shape[1])
    for row in range(got.shape[0]):
        a, b = got[row, :n].tolist(), ref[row, :n].tolist()
        if a == b:
            continue
        i = next(k for k in range(n) if a[k] != b[k])
        with torch.no_grad():
            logits = model(src[row:row + 1], ref[row:row + 1, :i])[0, -1]
        margin = float(logits[b[i]].float() - logits[a[i]].float())
        partings.append(margin)
        check(margin < tol, "%s row %d: token %d is %d, re-forward's %d "
              "(margin %.3g >= %g)" % (what, row, i, a[i], b[i], margin,
                                       tol))
    return got.shape[0], partings


def phase_nmt_translate(dev, model):
    """``translate`` at batch 8, ``max_len`` 64, on the trained bf16 model
    and on an fp32 one from the seed: greedy over the fixed cache equal to
    greedy by re-forward (fp32: every token, partings only at an fp32 tie
    under ``NMT_FP32_TIE``; bf16: up to a parting under
    ``GREEDY_TIE_TOL``), exactly 12 LayerNorm launches for the encoder
    and 18 a cached decode step, the time a token; ``beam=4`` on one
    sentence."""
    import torch
    from mxnet_tpu_torch.models.transformer import transformer_base

    r, tr = NMT_RECIPE, NMT_TRANSLATE
    B, L = tr["batch"], tr["max_len"]
    src = torch.from_numpy(np.random.default_rng(SEED + 7).integers(
        4, r["vocab"], (B, r["src_len"])).astype(np.int32)).to(dev)
    fp32 = transformer_base(r["vocab"], r["vocab"], max_len=r["max_len"],
                            dropout=0.1)
    fp32.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 8))
    out = {}
    for label, m, tol in (("bf16", model, GREEDY_TIE_TOL),
                          ("fp32", fp32, NMT_FP32_TIE)):
        m.translate(src[:1], max_len=4, device=dev)  # warm
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        cached = m.translate(src, max_len=L, device=dev)
        torch.cuda.synchronize()
        cached_s = time.perf_counter() - t0
        launches = read_counters()
        steps = cached.shape[1] - 1
        t0 = time.perf_counter()
        ref = m.translate(src, max_len=L, use_cache=False, device=dev)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        rows, partings = _greedy_parting(m, src, cached, ref, tol,
                                         "nmt %s greedy" % label)
        res = {"tokens": [int(cached.shape[1]), int(ref.shape[1])],
               "equal": bool(torch.equal(cached, ref)),
               "partings": partings, "decode_steps": steps,
               "launches": launches,
               "cached_ms_per_token": cached_s * 1e3 / steps,
               "reforward_ms_per_token": ref_s * 1e3 / max(
                   ref.shape[1] - 1, 1)}
        print("nmt %s translate batch %d, max_len %d: cached %s re-forward "
              "(%d partings, margins %s, limit %g); %.3f ms a token cached, "
              "%.3f ms by re-forward; launches %s" % (
                  label, B, L, "equal to" if res["equal"] else "parts from",
                  len(partings), ["%.3g" % p for p in partings], tol,
                  res["cached_ms_per_token"],
                  res["reforward_ms_per_token"],
                  {k: v for k, v in launches.items() if v}), flush=True)
        check(cached[:, 0].eq(2).all(), "translate does not start at bos")
        want = {"layernorm": NMT_ENCODE_LN + NMT_DECODE_LN * steps}
        for name, n in launches.items():
            check(n == want.get(name, 0), "nmt %s translate %s launches %d "
                  "!= %d" % (label, name, n, want.get(name, 0)))
        out[label] = res
    t0 = time.perf_counter()
    beam = model.translate(src[:1], max_len=L, beam=tr["beam"],
                           device=dev)
    torch.cuda.synchronize()
    out["beam"] = {"beam": tr["beam"], "tokens": int(beam.shape[1]),
                   "wall_ms": (time.perf_counter() - t0) * 1e3}
    print("nmt beam %d on one sentence: %d tokens in %.1f ms" % (
        tr["beam"], beam.shape[1], out["beam"]["wall_ms"]), flush=True)
    check(beam.shape[0] == 1 and 1 < beam.shape[1] <= L
          and int(beam[0, 0]) == 2, "beam search output %s"
          % (tuple(beam.shape),))
    return out


def phase_a11_timing(dev, records, lstm, nmt):
    """The kernels at this slice's shapes, each held to its plain version
    and timed against it, its library call and its bound, added to their
    records under ``lstm_train`` / ``nmt_train`` with the path's launches
    a step: LayerNorm forward and backward at the NMT step's (2048, 512)
    bf16, softmax-xent forward and backward at the LSTM's (1120, 10000)
    and the NMT's (2048, 32000) bf16 logits (dy = 1 / rows, the mean)."""
    import torch
    import torch.nn.functional as TF
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    g = torch.Generator(device=dev).manual_seed(SEED + 71)
    rec = {r["name"]: r for r in records}

    def entry(tag, path, name, times, bounds, shape, reading, library):
        t_ops, t_bytes = bounds
        launches, steps = path["launches"], path["steps_counted"]
        key = {"layernorm_fwd": "layernorm"}.get(name, name)
        out = dict(zip(("ms", "plain_ms", "library_ms"), times),
                   launches=launches[key],
                   launches_per_step=launches[key] / steps, shape=shape,
                   max_abs_err=reading["max_abs_err"], check=reading,
                   bound_ms=max(t_ops, t_bytes) * 1e3,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   library=library)
        rec[name][tag] = out
        print("time %s %-17s at %s: kernel %.4f ms, plain %.4f ms, library "
              "%.4f ms, bound %.4f ms (%s), %g launches a step"
              % (tag, name, shape, out["ms"], out["plain_ms"],
                 out["library_ms"], out["bound_ms"], out["bound_by"],
                 out["launches_per_step"]), flush=True)

    # LayerNorm at (2048, 512) bf16, eps 1e-5: C = 512 is a width no
    # earlier path ran
    R, C = NMT_RECIPE["batch"] * NMT_RECIPE["tgt_len"], 512
    x = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
    dy = torch.randn(R, C, device=dev, generator=g).to(torch.bfloat16)
    gamma = torch.randn(C, device=dev, generator=g)
    beta = torch.randn(C, device=dev, generator=g)
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    what = "nmt layernorm (%d, %d) bf16" % (R, C)
    fwd = held(ln.fused_layernorm(x, gamma, beta, 1e-5),
               ln.layernorm_plain(x, gamma, beta, 1e-5), BF16_TOL, what)
    entry("nmt_train", nmt, "layernorm_fwd", time_ms(
        lambda: ln.fused_layernorm(x, gamma, beta, 1e-5),
        lambda: ln.layernorm_plain(x, gamma, beta, 1e-5),
        lambda: TF.layer_norm(x, (C,), gb, bb, 1e-5)),
        _ln_bound(R, C, 2), [R, C], fwd, "F.layer_norm, bf16 gamma and "
        "beta")
    dx, dgamma, dbeta = ln.fused_layernorm_bwd(x, gamma, dy, 1e-5)
    torch.cuda.synchronize()
    ref = ln.layernorm_bwd_plain(x, gamma, dy, 1e-5)
    mags = layernorm_bwd_magnitudes(x, gamma, dy, 1e-5)
    bwd = {n: held(got, want, tol, what + " backward " + n, mag)
           for n, got, want, tol, mag in (
               ("dx", dx, ref[0], LN_BWD_DX_TOL["bfloat16"], mags[0]),
               ("dgamma", dgamma, ref[1], LN_BWD_PARAM_TOL, mags[1]),
               ("dbeta", dbeta, ref[2], LN_BWD_PARAM_TOL, mags[2]))}
    bwd["max_abs_err"] = max(r["max_abs_err"] for r in bwd.values())
    _, mean, rstd = torch.ops.aten.native_layer_norm(x, [C], gb, bb, 1e-5)
    entry("nmt_train", nmt, "layernorm_bwd", time_ms(
        lambda: ln.fused_layernorm_bwd(x, gamma, dy, 1e-5),
        lambda: ln.layernorm_bwd_plain(x, gamma, dy, 1e-5),
        lambda: torch.ops.aten.native_layer_norm_backward(
            dy, x, [C], mean, rstd, gb, bb, [True, True, True])),
        _ln_bwd_bound(R, C, 2), [R, C], bwd,
        "aten native_layer_norm_backward, bf16 gamma, the forward's mean "
        "and rstd given")
    del x, dy, dx, dgamma, dbeta, ref, mags, mean, rstd

    for tag, path, R, V in (
            ("lstm_train", lstm, LSTM_RECIPE["batch"] * LSTM_RECIPE["bptt"],
             LSTM_RECIPE["vocab"]),
            ("nmt_train", nmt, NMT_RECIPE["batch"] * NMT_RECIPE["tgt_len"],
             NMT_RECIPE["vocab"])):
        x = (torch.randn(R, V, device=dev, generator=g) * 3).to(
            torch.bfloat16)
        labels = torch.randint(0, V, (R,), device=dev, generator=g,
                               dtype=torch.int32)
        labels[0] = V - 1
        dy = torch.full((R,), 1.0 / R, device=dev)
        what = "%s softmax-xent (%d, %d) bf16" % (tag, R, V)
        loss, lse = sx.softmax_xent_fwd(x, labels)
        torch.cuda.synchronize()
        ref_loss, ref_lse = sx.softmax_xent_fwd_plain(x, labels)
        fwd = held(loss, ref_loss, XENT_TOL, what + " loss")
        fwd["lse"] = held(lse, ref_lse, XENT_TOL, what + " lse")
        dx = sx.softmax_xent_bwd(x, labels, ref_lse, dy)
        torch.cuda.synchronize()
        bwd = held(dx, sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy),
                   XENT_DX_TOL["bfloat16"], what + " dx")
        del loss, lse, ref_loss, dx
        xf = x.float().requires_grad_()
        lab64 = labels.long()

        def lib_fwd():
            return TF.cross_entropy(xf, lab64, reduction="none")

        def lib_fwd_bwd():
            return torch.autograd.grad(lib_fwd(), xf, dy)

        ms, plain_ms, lib_ms, lib_both = time_ms(
            lambda: sx.softmax_xent_fwd(x, labels),
            lambda: sx.softmax_xent_fwd_plain(x, labels), lib_fwd,
            lib_fwd_bwd)
        bwd_ms, bwd_plain_ms = time_ms(
            lambda: sx.softmax_xent_bwd(x, labels, ref_lse, dy),
            lambda: sx.softmax_xent_bwd_plain(x, labels, ref_lse, dy))
        ops = 5 * R * V
        xbytes = R * V * x.element_size()
        entry(tag, path, "softmax_xent_fwd", (ms, plain_ms, lib_ms),
              (ops / PEAK_FP32, (xbytes + 3 * R * 4) / PEAK_BYTES), [R, V],
              fwd, "F.cross_entropy(reduction='none') on fp32 logits")
        entry(tag, path, "softmax_xent_bwd",
              (bwd_ms, bwd_plain_ms, lib_both - lib_ms),
              (ops / PEAK_FP32, (2 * xbytes + 3 * R * 4) / PEAK_BYTES),
              [R, V], bwd, "backward of F.cross_entropy on fp32 logits "
              "(forward + backward less forward)")
        del x, xf, ref_lse
    torch.cuda.empty_cache()


def run_a11(dev):
    """The six A.11 phases in order, each one's seconds: (the LSTM, SSD and
    NMT steps for the breakdowns, the readings)."""
    out, seconds = {}, {}
    t0 = time.perf_counter()
    lstm_step, out["lstm_train"] = phase_lstm_train(dev)
    seconds["phase_lstm_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["lstm_infer"] = phase_lstm_infer(dev)
    seconds["phase_lstm_infer"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ssd_step, out["ssd_train"] = phase_ssd_train(dev)
    seconds["phase_ssd_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["ssd_detect"] = phase_ssd_detect(dev, ssd_step.net)
    seconds["phase_ssd_detect"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    nmt_step, out["nmt_train"] = phase_nmt_train(dev)
    seconds["phase_nmt_train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["nmt_translate"] = phase_nmt_translate(dev, nmt_step.model)
    seconds["phase_nmt_translate"] = time.perf_counter() - t0
    out["phase_seconds"] = seconds
    print("A.11 phases: %s, %.1f s together" % (
        {k: round(v, 1) for k, v in seconds.items()},
        sum(seconds.values())), flush=True)
    return (lstm_step, ssd_step, nmt_step), out


def a11_breakdowns(steps, out):
    """One torch.profiler window of the LSTM, SSD and NMT steps (kernel
    time by class, the device's idle share; the SSD step by the vision
    classes)."""
    lstm, ssd, nmt = steps
    out["lstm_train"]["breakdown"] = phase_train_breakdown(
        lstm, n_prof=1, label="lstm train step")
    out["ssd_train"]["breakdown"] = phase_resnet_breakdown(
        ssd, n_prof=1, label="ssd512 train step")
    out["nmt_train"]["breakdown"] = phase_train_breakdown(
        nmt, n_prof=1, label="nmt train step")


# ---------------------------------------------------------------- slice 15
# phase_convert: a torchvision ResNet-50 checkpoint converted into
# resnet50_v1b (fp32 logits within CONVERT_LOGIT_TOL of the largest logit of
# the torch reference model on the card), and HuggingFace-named BERT-base and
# GPT-2 small state dicts transplanted and run (served / greedy decoded)
CONVERT_BATCH = 8
CONVERT_LOGIT_TOL = 1e-3
CONVERT_GREEDY_TOKENS = 8
CONVERT_PROMPT = 300  # a prefill past FLASH_MIN_LEN: the causal flash runs


def _hf_bert_state(dev, seed, layers=12, units=768, inter=3072,
                   vocab=VOCAB, pos=SEQ, types=2):
    """A BertModel state dict with HuggingFace's key names (``bert.``
    prefix), seeded normal values of BERT's scale on ``dev``."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def w(*shape, one=False):
        t = torch.randn(shape, generator=g, device=dev) * 0.02
        return t + 1.0 if one else t

    s = {"embeddings.word_embeddings.weight": w(vocab, units),
         "embeddings.position_embeddings.weight": w(pos, units),
         "embeddings.token_type_embeddings.weight": w(types, units),
         "embeddings.LayerNorm.weight": w(units, one=True),
         "embeddings.LayerNorm.bias": w(units),
         "pooler.dense.weight": w(units, units), "pooler.dense.bias": w(units)}
    for i in range(layers):
        p = "encoder.layer.%d." % i
        for n in ("query", "key", "value"):
            s[p + "attention.self.%s.weight" % n] = w(units, units)
            s[p + "attention.self.%s.bias" % n] = w(units)
        s[p + "attention.output.dense.weight"] = w(units, units)
        s[p + "attention.output.dense.bias"] = w(units)
        s[p + "attention.output.LayerNorm.weight"] = w(units, one=True)
        s[p + "attention.output.LayerNorm.bias"] = w(units)
        s[p + "intermediate.dense.weight"] = w(inter, units)
        s[p + "intermediate.dense.bias"] = w(inter)
        s[p + "output.dense.weight"] = w(units, inter)
        s[p + "output.dense.bias"] = w(units)
        s[p + "output.LayerNorm.weight"] = w(units, one=True)
        s[p + "output.LayerNorm.bias"] = w(units)
    return {"bert." + k: v for k, v in s.items()}


def _hf_gpt2_state(dev, seed, cfg):
    """A GPT2LMHeadModel state dict with HuggingFace's key names
    (``transformer.`` prefix, Conv1D weights (in, out)), seeded."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    E, L = cfg["units"], cfg["num_layers"]

    def w(*shape, one=False):
        t = torch.randn(shape, generator=g, device=dev) * 0.02
        return t + 1.0 if one else t

    s = {"wte.weight": w(cfg["vocab_size"], E),
         "wpe.weight": w(cfg["max_length"], E) * 0.5,
         "ln_f.weight": w(E, one=True), "ln_f.bias": w(E)}
    for i in range(L):
        p = "h.%d." % i
        s[p + "ln_1.weight"], s[p + "ln_1.bias"] = w(E, one=True), w(E)
        s[p + "attn.c_attn.weight"], s[p + "attn.c_attn.bias"] = \
            w(E, 3 * E), w(3 * E)
        s[p + "attn.c_proj.weight"], s[p + "attn.c_proj.bias"] = \
            w(E, E), w(E)
        s[p + "ln_2.weight"], s[p + "ln_2.bias"] = w(E, one=True), w(E)
        s[p + "mlp.c_fc.weight"], s[p + "mlp.c_fc.bias"] = \
            w(E, 4 * E), w(4 * E)
        s[p + "mlp.c_proj.weight"], s[p + "mlp.c_proj.bias"] = \
            w(4 * E, E), w(E)
    return {"transformer." + k: v for k, v in s.items()}


def _served_rows(srv, reqs):
    """Each request of ``reqs`` alone through ``srv`` (one batch each),
    in order: the outputs, one list a request."""
    return [srv.predict(*r) for r in reqs]


def phase_convert(dev):
    """The converters at full width on the card: a torchvision ResNet-50
    checkpoint through ``get_model("resnet50_v1b", pretrained=...)``
    against the torch reference model, a HF BERT-base transplanted and
    served at seq 512, a HF GPT-2 small transplanted and greedy decoded."""
    import shutil
    import tempfile

    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.gluon.model_zoo import convert, vision
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.models.gpt import GPTModel
    from mxnet_tpu_torch.ops.cuda import _build
    from mxnet_tpu_torch.serve import ModelServer

    out = {}
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import torch_resnet_ref as tref

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    try:
        # (a) torchvision ResNet-50 -> resnet50_v1b, fp32 logits
        t0 = time.perf_counter()
        torch.manual_seed(SEED)
        ref = tref.randomize_bn_stats(tref.resnet50(num_classes=1000),
                                      seed=SEED).to(dev).eval()
        path = os.path.join(tmp, "resnet50.pth")
        torch.save(ref.state_dict(), path)
        net = vision.get_model("resnet50_v1b", pretrained=path,
                               classes=1000, ctx=dev)
        convert_s = time.perf_counter() - t0
        x = torch.randn(CONVERT_BATCH, 3, 224, 224, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            SEED))
        with torch.inference_mode():
            want = ref(x).float()
            got = net(x).float()
        err = max_err(got, want)
        big = float(want.abs().max())
        out["resnet50"] = {"max_abs_err": err, "max_abs_logit": big,
                           "limit": CONVERT_LOGIT_TOL * big,
                           "convert_s": convert_s}
        print("convert: torchvision resnet50 -> resnet50_v1b in %.2f s; "
              "fp32 logits max |port - torch| %.3g, max |logit| %.3g "
              "(limit %g x max)" % (convert_s, err, big, CONVERT_LOGIT_TOL),
              flush=True)
        check(bool(torch.isfinite(got).all()), "converted resnet50: "
              "non-finite logits")
        check(err <= CONVERT_LOGIT_TOL * big, "converted resnet50 logits "
              "disagree with the torch model's")
        del ref, net, got, want
        torch.cuda.empty_cache()

        # (b) HF BERT-base transplanted, served at seq 512
        state = _hf_bert_state(dev, SEED + 50)
        model = bert_base(dropout=0.1, max_length=SEQ)
        model.initialize(device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        convert.transplant_hf_bert(model, state)
        p0 = "bert.encoder.layer.0.attention.self."
        check(torch.equal(model.encoder.cells[0].attention.qkv.weight
                          ._tensor().detach(),
                          torch.cat([state[p0 + n + ".weight"]
                                     for n in ("query", "key", "value")])),
              "transplanted BERT: qkv is not [q; k; v]")
        del state
        amp.convert_hybrid_block(model, "bfloat16")
        specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
        srv = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                          timeout_ms=120000.0, device=dev)
        check_warm_graphs(srv.stats(), BUCKETS, "transplanted BERT server")
        tok, tt, vl = _bert_requests()
        reqs = [(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
                for i in range(N_REQUESTS)]
        with srv:
            reset_counters()
            b0 = srv.metrics.batches
            served = _served_rows(srv, reqs)
            counts = read_counters()
            forwards = srv.metrics.batches - b0
        check(counts["layernorm"] == 25 * forwards
              and counts["flash_attention_fwd"] == 12 * forwards,
              "transplanted BERT: launches %s in %d forwards"
              % (counts, forwards))
        ins = [torch.from_numpy(a).to(dev) for a in (tok, tt, vl)]
        with plain_versions(), torch.inference_mode():
            plain = [o.float().cpu().numpy() for o in model(*ins)]
        worst = 0.0
        for i, rows in enumerate(served):
            n = int(vl[i])
            for a, b in ((rows[0][0, :n], plain[0][i, :n]),
                         (rows[1][0], plain[1][i]), (rows[2][0], plain[2][i])):
                check(np.isfinite(a).all(), "transplanted BERT: non-finite "
                      "served row")
                worst = max(worst, float(np.abs(a - b).max()))
        out["bert"] = {"forwards": forwards, "launches": counts,
                       "served_vs_plain_max_abs": worst, "limit": MODEL_TOL}
        print("convert: HF BERT-base transplanted, %d requests served in %d "
              "forwards; launches %s; served rows vs the plain versions max "
              "abs %.3g (limit %g)" % (N_REQUESTS, forwards, counts, worst,
                                       MODEL_TOL), flush=True)
        check(worst <= MODEL_TOL, "transplanted BERT: served rows disagree "
              "with the plain versions")
        srv.stop()
        del srv, model
        torch.cuda.empty_cache()

        # (c) HF GPT-2 small transplanted, greedy decode
        state = _hf_gpt2_state(dev, SEED + 51, GPT_CONFIG)
        gpt = GPTModel(dropout=0.1, **GPT_CONFIG)
        gpt.initialize(device=dev, generator=torch.Generator(
            device=dev).manual_seed(SEED))
        convert.transplant_hf_gpt2(gpt, state)
        check(torch.equal(gpt.blocks[0].attn.qkv.weight._tensor().detach(),
                          state["transformer.h.0.attn.c_attn.weight"].t()),
              "transplanted GPT-2: c_attn is not transposed into qkv")
        del state
        amp.convert_hybrid_block(gpt, "bfloat16")
        prompt = np.random.RandomState(SEED + 52).randint(
            0, GPT_CONFIG["vocab_size"], CONVERT_PROMPT).tolist()
        reset_counters()
        toks, _ = greedy_reference(gpt, prompt, CONVERT_GREEDY_TOKENS, dev)
        counts = read_counters()
        with plain_versions():
            ptoks, plogits = greedy_reference(gpt, prompt,
                                              CONVERT_GREEDY_TOKENS, dev)
        compared, margin = compare_greedy(toks, ptoks, plogits.cpu().numpy(),
                                          "transplanted GPT-2 greedy")
        out["gpt2"] = {"tokens": toks, "plain_tokens": ptoks,
                       "compared": compared, "parted_margin": margin,
                       "launches": counts}
        print("convert: HF GPT-2 small transplanted, greedy %d tokens after "
              "a %d-token prompt: %s; plain versions %s (equal over %d, "
              "parted margin %s); launches %s" % (
                  CONVERT_GREEDY_TOKENS, CONVERT_PROMPT, toks, ptoks,
                  compared, margin, counts), flush=True)
        check(counts["layernorm"] == 25 * CONVERT_GREEDY_TOKENS
              and counts["flash_attention_fwd"] == 12,
              "transplanted GPT-2: launches %s" % counts)
        del gpt
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# phase_dist_train: the GPT-2 step (GPT_TRAIN) through dist.attach over an
# NCCL group of one rank, mesh {"dcn": 1, "dp": 1}: every collective of the
# hierarchy launches. Uncompressed, each ZeRO stage's DIST_STEPS steps must
# land as close to the plain Trainer's as a second plain run does (the
# phase_nd_train criterion: the flash dq sums in no fixed order);
# compressed, one step each with acc == deq(payload) + residual exactly.
DIST_STEPS = 2
DIST_COMPRESSIONS = ("fp16", "int8", "2bit")
# the dist update from given gradients against the plain Trainer's: at one
# rank the exchange and the sharded update change no value
DIST_UPDATE_TOL = 1e-6
ADAM = {"learning_rate": 1e-4, "wd": 0.01, "multi_precision": True}


def _param_snapshot(step):
    return [p._tensor().detach().clone() for p in step.params]


def _params_gap(params, ref):
    """(max |a - b|, count of parameters that differ) over two snapshots."""
    import torch

    worst, n = 0.0, 0
    for a, b in zip(params, ref):
        if not torch.equal(a, b):
            n += 1
            worst = max(worst, max_err(a, b))
    return worst, n


def _dist_steps(step, init, n_steps, mesh=None, zero=0, compression=None,
                fault=None):
    """``n_steps`` GPT steps from ``init`` with a fresh Adam trainer, plain
    (``mesh`` None) or through ``dist.attach``; returns (the parameters
    after, per-step readings)."""
    import torch
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch import random as mx_random

    with torch.no_grad():
        for p, s in zip(step.params, init):
            p._tensor().copy_(s)
    step.trainer = gluon.Trainer(step.model.collect_params(), "adam", ADAM)
    handle, exact, saved_split = None, [], None
    if mesh is not None:
        handle = dist.attach(step.trainer, mesh, ici_axis="dp",
                             dcn_axis="dcn", zero=zero,
                             compression=({"type": compression}
                                          if compression else None),
                             average=True, record_events=True)
        if compression:
            quant, deq = handle.strategy._codec

            def checked(acc):
                payload, res = quant(acc)
                exact.append(torch.equal(deq(payload) + res, acc))
                return payload, res

            handle.strategy._codec = (checked, deq)
        if fault is not None:
            saved_split = dist.GradientBucketer.split
            dist.GradientBucketer.split = staticmethod(
                lambda vec, like: fault(saved_split(vec, like)))
    rows = []
    try:
        for i in range(n_steps):
            mx_random.seed(SEED + i)
            if handle is not None:
                handle.gather_params()
            torch.cuda.synchronize()
            reset_counters()
            b0 = dist.bucket_counter.count
            c0 = dist.plan_counter.count
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            loss = step()
            end.record()
            enqueue = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            row = {"loss": float(loss.mean()), "launches": read_counters(),
                   "host_enqueue_ms": enqueue,
                   "host_wall_ms": (time.perf_counter() - t0) * 1e3,
                   "device_ms": start.elapsed_time(end)}
            if handle is not None:
                ex = handle.exchanger
                ev = ex.last_events
                row.update(
                    buckets=len(ex._plan),
                    bucket_launches=dist.bucket_counter.count - b0,
                    plans=dist.plan_counter.count - c0,
                    overlap_window_ms=ex.overlap_window_ms,
                    first_bucket_before_last_grad_ms=(
                        ev["bucket_done"][0].elapsed_time(
                            ev["grad_landed"][-1])
                        if ev["bucket_done"] else None))
            rows.append(row)
        if handle is not None:
            handle.gather_params()
        params = _param_snapshot(step)
    finally:
        if saved_split is not None:
            dist.GradientBucketer.split = saved_split
        if handle is not None:
            dist.detach(step.trainer)
    if compression:
        rows[-1]["codec_exact"] = bool(all(exact)) and len(exact) > 0
    return params, rows


def _dist_grads(step, init, mesh=None, zero=0, fault=None):
    """One GPT step's gradients from ``init`` without the update: plain, or
    exchanged through ``dist.attach`` at ZeRO ``zero`` and finished as
    ``Trainer.allreduce_grads`` would (at ZeRO 2 and 3 the rank's blocks,
    whole at one rank)."""
    import torch
    from mxnet_tpu_torch import dist, gluon
    from mxnet_tpu_torch import random as mx_random

    with torch.no_grad():
        for p, s in zip(step.params, init):
            p._tensor().copy_(s)
    step.trainer = gluon.Trainer(step.model.collect_params(), "adam", ADAM)
    handle = saved = None
    if mesh is not None:
        handle = dist.attach(step.trainer, mesh, ici_axis="dp",
                             dcn_axis="dcn", average=True, zero=zero)
        if fault is not None:
            saved = dist.GradientBucketer.split
            dist.GradientBucketer.split = staticmethod(
                lambda vec, like: fault(saved(vec, like)))
    try:
        mx_random.seed(SEED)
        if handle is not None:
            handle.gather_params()
        step(update=False)
        if handle is None:
            return _grads(step.params)
        handle.finish()
        return [handle.grad_shards.get(id(p), p._data.grad).detach().clone()
                for p in step.params]
    finally:
        if saved is not None:
            dist.GradientBucketer.split = saved
        if handle is not None:
            dist.detach(step.trainer)


def _fp32_values(step):
    """Each parameter's fp32 value after an update: its multi-precision
    master, else the weight itself."""
    states = step.trainer._whole_states()
    slot = {id(p): i for i, p in enumerate(step.trainer._params)}
    out = []
    for p in step.params:
        s = states.get(slot.get(id(p)))
        out.append((s["master"] if isinstance(s, dict) and "master" in s
                    else p._tensor()).detach().float().clone())
    return out


def _dist_update(step, init, grads, mesh=None, zero=0, fault=None):
    """One Adam update from ``init`` with the given gradients, no backward:
    the plain Trainer's, or through ``dist.attach`` at ZeRO ``zero`` (the
    exchange, which ``finish()`` launches for every bucket, then the
    sharded update and at ZeRO 3 the release and gather). Returns (the
    weights, their fp32 values) after."""
    import torch
    from mxnet_tpu_torch import dist, gluon

    with torch.no_grad():
        for p, s in zip(step.params, init):
            p._tensor().copy_(s)
    step.trainer = gluon.Trainer(step.model.collect_params(), "adam", ADAM)
    handle = None
    if mesh is not None:
        handle = dist.attach(step.trainer, mesh, ici_axis="dp",
                             dcn_axis="dcn", average=True, zero=zero)
    if fault is not None:
        opt = step.trainer._optimizer
        opt.fused_update = fault(opt.fused_update)
    try:
        if handle is not None:
            handle.gather_params()
        for p, g in zip(step.params, grads):
            p._tensor().grad = g.clone()
        step.trainer.step(GPT_TRAIN["batch"])
        if handle is not None:
            handle.gather_params()
        return _param_snapshot(step), _fp32_values(step)
    finally:
        if handle is not None:
            dist.detach(step.trainer)


def first_block_kept(fused):
    """A planted fault: the update skips the first weight's block (the
    rank's block of it under ZeRO; weight and state keep their values)."""
    def skipped(ws, gs, ss, idx=None):
        idx = list(range(len(ws))) if idx is None else list(idx)
        return [ss[0]] + fused(ws[1:], gs[1:], ss[1:], idx[1:])

    return skipped


def _update_gap(got, ref, init):
    """(the worst parameter's |fp32 step - the plain one's| / |the plain
    one| in L2, the count of bf16 weights not bitwise the plain's)."""
    import torch

    weights, values = got
    ref_w, ref_v = ref
    worst = 0.0
    for v, rv, s in zip(values, ref_v, init):
        den = float((rv - s.float()).norm())
        num = float((v - rv).norm())
        worst = max(worst, num / den if den > 0 else num)
    return worst, sum(not torch.equal(a, b) for a, b in zip(weights, ref_w))


def last_member_dropped(parts):
    """A planted fault: a bucket's last member reads zeros instead of its
    reduced gradient."""
    import torch

    parts[-1] = torch.zeros_like(parts[-1])
    return parts


def _check_dist_row(row, what):
    for name, n in GPT_STEP_LAUNCHES.items():
        check(row["launches"][name] == n, "%s: %s launches %d != %d"
              % (what, name, row["launches"][name], n))
    check(row["launches"]["flash_attention_fwd_f32"] == 0,
          "%s launched the fp32 flash form" % what)
    check(np.isfinite(row["loss"]), "%s: non-finite loss" % what)
    if "buckets" in row:
        check(row["bucket_launches"] == row["buckets"] and row["plans"] == 0,
              "%s: %d bucket launches for a plan of %d, %d plans made"
              % (what, row["bucket_launches"], row["buckets"], row["plans"]))
        check((row["first_bucket_before_last_grad_ms"] or 0) > 0,
              "%s: the first bucket's whole exchange did not end before the "
              "backward's last gradient landed (%s ms)"
              % (what, row["first_bucket_before_last_grad_ms"]))


def phase_dist_train(dev):
    """GPT-2 small trained through ``dist.attach`` at ZeRO 0-3 and each
    compression over an NCCL group of one rank, held to the plain Trainer;
    a planted bucket fault; then ``ModelServer(devices=[card, card])`` on
    BERT-base at seq 512."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    distributed.init_process_group(device=dev)
    mesh = parallel.make_mesh({"dcn": 1, "dp": 1})
    step = GPTTrainStep(dev)
    init = _param_snapshot(step)
    out = {"mesh": mesh.shape, "backend": torch.distributed.get_backend(),
           "card": card_line()}
    ref, rows_a = _dist_steps(step, init, DIST_STEPS)
    again, rows_c = _dist_steps(step, init, DIST_STEPS)
    own_gap, own_n = _params_gap(again, ref)
    del again
    for r in rows_a + rows_c:
        _check_dist_row(r, "plain gpt2 step")
    out["plain"] = {"steps": rows_a, "second_run_gap": [own_gap, own_n]}
    print("dist: plain gpt2 steps %s; a second plain run differs in %d "
          "parameters (max %.3g)" % ([round(r["loss"], 5) for r in rows_a],
                                     own_n, own_gap), flush=True)
    out["zero"] = {}
    for zero in (0, 1, 2, 3):
        got, rows = _dist_steps(step, init, DIST_STEPS, mesh, zero)
        gap, n = _params_gap(got, ref)
        del got
        for r in rows:
            _check_dist_row(r, "dist gpt2 step, zero %d" % zero)
        # a reading: Adam's steps are about the sign of each gradient, so
        # the flash backward's run-to-run noise moves the parameters as
        # much as a fault would; the checks with teeth follow
        out["zero"][zero] = {"steps": rows, "gap": [gap, n]}
        print("dist zero %d: losses %s, %d buckets, %d bucket launches a "
              "step, first bucket's whole exchange done %.3f ms before the "
              "last gradient; host enqueue %.1f ms, wall %.1f ms, device "
              "%.1f ms a step; vs plain: %d parameters differ (max %.3g; the "
              "plain run's own %d, %.3g)" % (
                  zero, [round(r["loss"], 5) for r in rows],
                  rows[-1]["buckets"], rows[-1]["bucket_launches"],
                  rows[-1]["first_bucket_before_last_grad_ms"] or 0.0,
                  rows[-1]["host_enqueue_ms"], rows[-1]["host_wall_ms"],
                  rows[-1]["device_ms"], n, gap, own_n, own_gap), flush=True)
    # at every ZeRO stage the exchanged gradients against the plain
    # step's (GPT-2's gradient and row limits), honest and with a planted
    # fault at ZeRO 0: each bucket's last member reads zeros
    out["gradients"] = {}
    plain_grads = _dist_grads(step, init)
    cases = [("plain step again", None, 0, None)] + [
        ("attached, zero %d" % z, mesh, z, None) for z in (0, 1, 2, 3)] + [
        ("attached, zero 0, each bucket's last member dropped", mesh, 0,
         last_member_dropped)]
    for label, mesh_, zero, fault in cases:
        grads = _dist_grads(step, init, mesh_, zero, fault)
        r = {"worst_grad_rel_l2": grad_rel_l2(step.params, grads,
                                              plain_grads)[0][0],
             "worst_row_rel_l2": grad_row_rel_l2(step.params, grads,
                                                 plain_grads)[0][0]}
        del grads
        r["within"] = (r["worst_grad_rel_l2"] <= GPT_STEP_GRAD_TOL
                       and r["worst_row_rel_l2"] <= GPT_STEP_ROW_TOL)
        out["gradients"][label] = r
        print("dist gradients, %s, vs the plain step's: worst relative L2 "
              "%.3g (limit %g), worst row %.3g (limit %g)" % (
                  label, r["worst_grad_rel_l2"], GPT_STEP_GRAD_TOL,
                  r["worst_row_rel_l2"], GPT_STEP_ROW_TOL), flush=True)
        check(r["within"] == (fault is None), "dist gradients, %s: the "
              "limits %s it" % (label, "refuse" if fault is None
                                else "miss"))
    # at every ZeRO stage the update from the plain step's gradients
    # against the plain Trainer's (deterministic: the same gradients in),
    # honest and with the first weight block's update skipped, planted
    out["update"] = {}
    plain_upd = _dist_update(step, init, plain_grads)
    for zero in (0, 1, 2, 3):
        for label, fault in (("", None),
                             (", first block's update skipped",
                              first_block_kept)):
            worst, differ = _update_gap(
                _dist_update(step, init, plain_grads, mesh, zero, fault),
                plain_upd, init)
            r = {"worst_step_rel_l2": worst, "bf16_weights_differ": differ,
                 "within": worst <= DIST_UPDATE_TOL and differ == 0}
            out["update"]["zero %d%s" % (zero, label)] = r
            print("dist update, zero %d%s, vs the plain Trainer's from the "
                  "same gradients: worst fp32 step relative L2 %.3g (limit "
                  "%g), %d bf16 weights not bitwise equal" % (
                      zero, label, worst, DIST_UPDATE_TOL, differ),
                  flush=True)
            check(r["within"] == (fault is None), "dist update, zero %d%s: "
                  "the limit %s it" % (zero, label, "refuses" if fault is None
                                       else "misses"))
    del plain_grads, plain_upd
    out["compressed"] = {}
    for comp in DIST_COMPRESSIONS:
        for zero in (0, 1, 2, 3):
            _, rows = _dist_steps(step, init, 1, mesh, zero, comp)
            _check_dist_row(rows[0], "dist %s zero %d" % (comp, zero))
            out["compressed"]["%s_zero%d" % (comp, zero)] = rows[0]
            check(rows[0]["codec_exact"], "dist %s zero %d: acc != "
                  "deq(payload) + residual" % (comp, zero))
    print("dist compressed steps (fp16/int8/2bit x zero 0-3): losses %s; "
          "acc == deq(payload) + residual exactly in every bucket"
          % {k: round(v["loss"], 5) for k, v in out["compressed"].items()},
          flush=True)
    del step, init, ref
    torch.cuda.empty_cache()
    distributed.shutdown()
    out["replicas"] = phase_serve_replicas(dev)
    out["phase_seconds"] = time.perf_counter() - t_phase
    print("dist phase: %.1f s on %s" % (out["phase_seconds"], out["card"]),
          flush=True)
    return out


def _host_ops(step, top=12):
    """The host's busiest torch ops of one step (self CPU ms, calls) under
    torch.profiler, printed: where the exchange's host time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
        torch.cuda.synchronize()
    rows = sorted(((ev.self_cpu_time_total / 1e3, ev.count, ev.key)
                   for ev in prof.key_averages()
                   if not ev.key.startswith("mxnet_tpu_torch::")),
                  reverse=True)[:top]
    print("  host ops of one step (self CPU ms, calls): %s" % "; ".join(
        "%s %.2f x%d" % (k[:40], ms, n) for ms, n, k in rows), flush=True)
    return [[k, ms, n] for ms, n, k in rows]


def phase_dist_breakdown(dev):
    """The GPT-2 step through ``dist.attach`` (zero 0 and 1, NCCL at one
    rank) under torch.profiler: kernel time by class, the host and device
    time of the exchange's ranges, the idle share (the plain step's is
    ``phase_train_breakdown``'s "gpt2 train step")."""
    from mxnet_tpu_torch import dist, parallel
    from mxnet_tpu_torch.parallel import distributed

    distributed.init_process_group(device=dev)
    out = {}
    try:
        mesh = parallel.make_mesh({"dcn": 1, "dp": 1})
        step = GPTTrainStep(dev)
        for zero in (0, 1):
            dist.attach(step.trainer, mesh, ici_axis="dp", dcn_axis="dcn",
                        zero=zero, average=True)
            try:
                out["zero%d" % zero] = phase_train_breakdown(
                    step, label="gpt2 dist step, zero %d" % zero)
                out["zero%d" % zero]["host_ops"] = _host_ops(step)
            finally:
                dist.detach(step.trainer)
        del step
    finally:
        distributed.shutdown()
    return out


def phase_serve_replicas(dev):
    """BERT-base at seq 512 through ``ModelServer(devices=[card, card])``:
    two replicas with their own bucket graphs, batches alternating, rows
    bitwise a one-replica server's on the same weights, no capture in
    traffic, a swap reaching both replicas."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    one = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, device=dev)
    two = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, devices=[dev, dev])
    warm = two.stats()
    for r in warm["replicas"]:
        check_warm_graphs(r, BUCKETS, "replica server")
    tok, tt, vl = _bert_requests()
    reqs = [(tok[i:i + 1], tt[i:i + 1], vl[i:i + 1])
            for i in range(N_REQUESTS)]

    def same(a, b):
        return outputs_equal(list(a), list(b))

    with one, two:
        want = _served_rows(one, reqs)
        got = _served_rows(two, reqs)
    st = two.stats()
    batches = [r["batches"] for r in st["replicas"]]
    equal = all(same(g, w) for g, w in zip(got, want))
    check(equal, "replica server rows differ from one replica's")
    check(batches == [N_REQUESTS // 2] * 2, "batches did not alternate "
          "between the replicas: %s" % batches)
    check([r["captures"] for r in st["replicas"]] ==
          [r["captures"] for r in warm["replicas"]],
          "the replica server captured in traffic")
    good, bad = _bert_swap_files(dev, SEED + 53, None)
    try:
        two.swap_parameters(good)
        with one, two:
            after_one = _served_rows(one, reqs[:4])
            after_two = _served_rows(two, reqs[:4])
    finally:
        import shutil

        shutil.rmtree(os.path.dirname(good), ignore_errors=True)
    swapped = all(same(a, b) for a, b in zip(after_two, after_one)) and \
        not same(after_two[0], want[0])
    out = {"batches": batches, "rows_equal": equal, "swap_reached_both":
           swapped, "captures": [r["captures"] for r in st["replicas"]]}
    print("replica server: 2 replicas on %s, batches %s, rows bitwise one "
          "replica's %s, captures %s (none in traffic), a swap reached "
          "both %s" % (dev, batches, equal, out["captures"], swapped),
          flush=True)
    check(swapped, "a swap did not reach both replicas")
    one.stop()
    two.stop()
    return out


MP_RING = {"batch": 8, "heads": 12, "seq": 1024, "head_dim": 64, "n": 4}
# the n = 4 ring replayed on one card against fp32 whole-sequence
# attention: each of out, lse, dq, dk and dv no more than this many times
# as far (relative L2) as the one whole-sequence flash kernel's own
MP_RING_ERR_RATIO = 2.0
MP_FFN = {"units": 768, "hidden": 3072, "tokens": 4096}
MOE = {"units": 768, "experts": 8, "hidden": 3072, "tokens": 8 * 1024,
       "capacity_factor": 2.0}
# moe_ffn in bf16 against its plain per-expert math in fp32 on the same
# inputs: bf16 rounds the FFN's hidden activations and the output, 2^-9
# each; the limit leaves 4x
MOE_REL_TOL = 2.0 ** -7
PIPE = {"micro": 4, "batch": 2, "seq": 512}
SYNC_BN_SHAPE = (32, 64, 56, 56)  # a ResNet-50 stage-1 BatchNorm's input
# the 1F1B step at pp = 1 against the same microbatches' losses and
# gradients accumulated in the same order without the schedule, in fp32
PIPE_REL_TOL = 1e-6


def _sp_steps(step, init, scope=None):
    """GPT_TRAIN_STEPS GPT steps from ``init`` with a fresh Adam trainer,
    inside ``scope`` (a sequence_parallel_scope) or plain; returns per step
    (the per-sample loss, the launches) and the parameters after each."""
    import contextlib

    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import random as mx_random

    with torch.no_grad():
        for p, s in zip(step.params, init):
            p._tensor().copy_(s)
    step.trainer = gluon.Trainer(step.model.collect_params(), "adam", ADAM)
    rows, snaps = [], []
    for i in range(GPT_TRAIN_STEPS):
        mx_random.seed(SEED + i)
        torch.cuda.synchronize()
        reset_counters()
        with scope if scope is not None else contextlib.nullcontext():
            loss = step()
        torch.cuda.synchronize()
        rows.append({"loss": loss.clone(), "launches": read_counters()})
        snaps.append(_param_snapshot(step))
    return rows, snaps


def _sp_grads(step, init, scope=None):
    """One step's gradients from ``init`` (no update), inside ``scope`` or
    plain."""
    import contextlib

    import torch
    from mxnet_tpu_torch import random as mx_random

    with torch.no_grad():
        for p, s in zip(step.params, init):
            p._tensor().copy_(s)
    mx_random.seed(SEED)
    with scope if scope is not None else contextlib.nullcontext():
        step(update=False)
    return _grads(step.params)


def _sp_gpt(dev, mesh):
    """The main path: GPT-2 small's step inside sequence_parallel_scope
    over the sp = 1 mesh, ring and Ulysses, against the plain step. The
    flash dq sums in no fixed order, so which parameters differ from a
    run to the next moves by a few (a count is a reading, not a check):
    held exactly are the first loss and, after the first step, the
    parameters no dq reaches (the last block's attn_out, ln2 and FFN,
    and ln_f); the gradients are held to the plain step's by GPT-2's
    limits, beside a second plain run's reading."""
    import torch
    from mxnet_tpu_torch import parallel

    step = GPTTrainStep(dev)
    init = _param_snapshot(step)
    last = step.model.blocks[-1]
    names = {p.name for b in (last.attn.attn_out, last.ln2, last.ffn_1,
                              last.ffn_2, step.model.ln_f)
             for p in b.collect_params().values()}
    fixed = [i for i, p in enumerate(step.params) if p.name in names]
    plain, ref = _sp_steps(step, init)
    _, again = _sp_steps(step, init)
    own = [_params_gap(a, r)[1] for a, r in zip(again, ref)]
    own_fixed = all(torch.equal(again[0][i], ref[0][i]) for i in fixed)
    del again
    plain_grads = _sp_grads(step, init)
    own_grads = _sp_grads(step, init)
    out = {"second_plain_run_differs": own, "unreached": len(fixed),
           "second_plain_run_unreached_equal": own_fixed,
           "second_plain_run_grads": _grad_reading(step, own_grads,
                                                   plain_grads)}
    del own_grads
    check(len(fixed) == 10, "sp=1: %d parameters outside the dq's reach, "
          "want 10" % len(fixed))
    for impl in ("ring", "ulysses"):
        scope = parallel.sequence_parallel_scope(mesh, impl=impl)
        rows, snaps = _sp_steps(step, init, scope)
        gap = [_params_gap(a, r)[1] for a, r in zip(snaps, ref)]
        unreached = all(torch.equal(snaps[0][i], ref[0][i]) for i in fixed)
        del snaps
        first = bool(torch.equal(rows[0]["loss"], plain[0]["loss"]))
        launches = [r["launches"] for r in rows]
        grads = _grad_reading(step, _sp_grads(step, init, scope),
                              plain_grads)
        out[impl] = {"first_loss_bitwise": first, "differs": gap,
                     "unreached_equal": unreached, "grads": grads,
                     "losses": [float(r["loss"].mean()) for r in rows],
                     "launches": launches}
        print("model parallel: gpt2 step in sequence_parallel_scope(sp=1, "
              "%s): losses %s (plain %s), first bit for bit %s; the %d "
              "parameters no dq reaches equal after the first step %s (a "
              "second plain run's %s); parameters differing after each "
              "step %s (a second plain run's %s, a reading); gradients vs "
              "the plain step's: worst %.3g, worst row %.3g (a second plain "
              "run's %.3g, %.3g; limits %g, %g); launches a step %s" % (
                  impl, ["%.5f" % x for x in out[impl]["losses"]],
                  ["%.5f" % float(r["loss"].mean()) for r in plain], first,
                  len(fixed), unreached, own_fixed, gap, own,
                  grads["worst_grad_rel_l2"], grads["worst_row_rel_l2"],
                  out["second_plain_run_grads"]["worst_grad_rel_l2"],
                  out["second_plain_run_grads"]["worst_row_rel_l2"],
                  GPT_STEP_GRAD_TOL, GPT_STEP_ROW_TOL, launches[0]),
              flush=True)
        check(first, "sp=1 %s: the first loss is not the plain step's" % impl)
        check(unreached, "sp=1 %s: a parameter no dq reaches differs from "
              "the plain step's after the first step" % impl)
        check(grads["within"], "sp=1 %s: gradients outside GPT-2's limits: "
              "%s" % (impl, grads))
        for i, got in enumerate(launches):
            for name, n in GPT_STEP_LAUNCHES.items():
                check(got[name] == n, "sp=1 %s step %d: %s launches %d != %d"
                      % (impl, i, name, got[name], n))
    del step, init, ref, plain_grads
    return out


def _grad_reading(step, grads, ref):
    r = {"worst_grad_rel_l2": grad_rel_l2(step.params, grads, ref)[0][0],
         "worst_row_rel_l2": grad_row_rel_l2(step.params, grads, ref)[0][0]}
    r["within"] = (r["worst_grad_rel_l2"] <= GPT_STEP_GRAD_TOL
                   and r["worst_row_rel_l2"] <= GPT_STEP_ROW_TOL)
    return r


def _ring_case(q, k, v, do, causal, ref):
    """The n = 4 ring replayed (every rank's schedule, no communication)
    against the whole-sequence kernels, both held to ``ref``; with a
    merge that drops one block's correction (planted)."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.parallel.ring_attention import (merge_block,
                                                         ring_replay)

    n = MP_RING["n"]
    B, H, T, _ = q.shape
    reset_counters()
    o_w, lse_w = fa.flash_attention(q, k, v, causal=causal, return_lse=True)
    delta = (o_w.float() * do.float()).sum(dim=-1)
    g_w = fa.flash_attention_bwd(q, k, v, do, lse_w, delta, causal=causal)
    whole_launches = read_counters()
    torch.cuda.synchronize()
    reset_counters()
    o_r, lse_r, g_r = ring_replay(q, k, v, n, causal=causal, do=do,
                                  flash=True)
    torch.cuda.synchronize()
    ring_launches = read_counters()
    names = ("out", "lse", "dq", "dk", "dv")
    whole = [o_w, lse_w.reshape(B, H, T)] + list(g_w)
    ring = [o_r, lse_r] + list(g_r)
    errs = {nm: [_rel(w, r), _rel(g, r)]
            for nm, w, g, r in zip(names, whole, ring, ref)}
    within = {nm: e[1] <= MP_RING_ERR_RATIO * e[0] for nm, e in errs.items()}

    merges = []

    def dropped(acc, lse_acc, o, lse):
        if acc is not None:
            merges.append(1)
        if len(merges) != 1 or acc is None:
            return merge_block(acc, lse_acc, o, lse)
        new = torch.logaddexp(lse_acc, lse)  # the second block's weight left out
        return acc * torch.exp(lse_acc - new)[..., None] + o.float(), new

    o_f, _ = ring_replay(q, k, v, n, causal=causal, flash=True,
                         merge=dropped)
    fault = _rel(o_f, ref[0])
    want = (n * (n + 1) // 2) if causal else n * n
    case = {"causal": causal, "rel_l2_whole_ring": errs, "within": within,
            "launches": ring_launches, "whole_launches": whole_launches,
            "expected_launches": want, "skipped": n * n - want,
            "planted_merge_fault_out_rel_l2": fault,
            "planted_caught": fault > MP_RING_ERR_RATIO * errs["out"][0]}
    print("model parallel: ring n=%d on %s causal=%s: relative L2 to fp32 "
          "(whole kernel, ring) %s; launches %s (want %d each way, %d "
          "skipped); planted merge fault out %.3g, caught %s" % (
              n, tuple(q.shape), causal,
              {k_: ["%.3g" % x for x in e] for k_, e in errs.items()},
              {k_: v_ for k_, v_ in ring_launches.items() if v_}, want,
              n * n - want, fault, case["planted_caught"]), flush=True)
    check(all(within.values()), "ring n=%d causal=%s: farther than %gx the "
          "whole kernel's error: %s" % (n, causal, MP_RING_ERR_RATIO, errs))
    check(ring_launches["flash_attention_fwd"] == want
          and ring_launches["flash_attention_bwd"] == want,
          "ring n=%d causal=%s: launches %s, want %d each way"
          % (n, causal, ring_launches, want))
    check(case["planted_caught"], "ring: the planted merge fault passes")
    return case


def _ring_reference(q, k, v, do, causal):
    """fp32 whole-sequence attention (``full_attention``) and its
    gradients; the lse in fp64 (an fp32 logsumexp rounds as much as the
    kernels do)."""
    import math

    import torch
    from mxnet_tpu_torch.parallel import full_attention

    qf, kf, vf = (t.float().requires_grad_(True) for t in (q, k, v))
    o = full_attention(qf, kf, vf, causal=causal)
    o.backward(do.float())
    s = torch.matmul(q.double(), k.double().transpose(-1, -2)) / math.sqrt(
        q.shape[-1])
    if causal:
        T = q.shape[2]
        s = s.masked_fill(~torch.ones(T, T, dtype=torch.bool,
                                      device=q.device).tril(), -math.inf)
    lse = torch.logsumexp(s, dim=-1)
    del s
    return [o.detach(), lse, qf.grad, kf.grad, vf.grad]


def _ring_n4(dev):
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.parallel.ring_attention import ring_replay

    B, H, T, D = (MP_RING[k] for k in ("batch", "heads", "seq", "head_dim"))
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    q, k, v, do = (torch.randn(B, H, T, D, device=dev, generator=g).to(
        torch.bfloat16) for _ in range(4))
    cases = []
    for causal in (True, False):
        ref = _ring_reference(q, k, v, do, causal)
        cases.append(_ring_case(q, k, v, do, causal, ref))
        del ref
        torch.cuda.empty_cache()
    def whole():
        return fa.flash_attention(q, k, v, causal=True, return_lse=True)

    def ring():
        return ring_replay(q, k, v, MP_RING["n"], causal=True, flash=True)

    # device time by graph replay, and the eager call between two events
    # (the host's launches and the block copies included)
    dev_ms = time_ms(whole, ring, rounds=3, iters=5)
    whole()
    ring()
    eager_ms = [device_step_ms(whole, 5)[0], device_step_ms(ring, 5)[0]]
    t0 = time.perf_counter()
    ring()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    print("model parallel: causal forward at %s: whole kernel %.4f ms of "
          "device (%.4f eager), the n=%d ring replayed on one card %.4f ms "
          "of device (%.4f eager, %.3f ms of host enqueue); a reading, %s"
          % ((B, H, T, D), dev_ms[0], eager_ms[0], MP_RING["n"], dev_ms[1],
             eager_ms[1], enqueue_ms, card_line()), flush=True)
    return {"cases": cases, "causal_forward_ms": {
        "whole_device": dev_ms[0], "ring_replay_device": dev_ms[1],
        "whole_eager": eager_ms[0], "ring_replay_eager": eager_ms[1],
        "ring_replay_host_enqueue": enqueue_ms}}


def _ffn_step_equal(dev, mesh):
    """build_train_step with TRANSFORMER_RULES specs on {dp: 1, tp: 1}
    against the unsharded step, a GPT-2 block's FFN at its widths."""
    import torch
    from mxnet_tpu_torch import optimizer as opt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    C, Hd, N = MP_FFN["units"], MP_FFN["hidden"], MP_FFN["tokens"]
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    whole = {"ffn_1_weight": torch.randn(Hd, C, device=dev, generator=g)
             * 0.02, "ffn_1_bias": torch.zeros(Hd, device=dev),
             "ffn_2_weight": torch.randn(C, Hd, device=dev, generator=g)
             * 0.02}
    batch = (torch.randn(N, C, device=dev, generator=g),
             torch.randn(N, C, device=dev, generator=g))

    def loss_fn(params, b, key):
        x, y = b
        h = torch.nn.functional.gelu(x @ params["ffn_1_weight"].T
                                     + params["ffn_1_bias"])
        return ((h @ params["ffn_2_weight"].T - y) ** 2).mean()

    specs = {k: tp.spec_for(k, tuple(v.shape), tp.TRANSFORMER_RULES, mesh)
             for k, v in whole.items()}
    runs = {}
    for tag, kw in (("unsharded", {}), ("sharded", {
            "mesh": mesh, "param_spec": specs,
            "batch_spec": (parallel.P("dp"), parallel.P("dp"))})):
        adam = opt.Adam(learning_rate=1e-3)
        params = {k: v.clone() for k, v in whole.items()}
        if tag == "sharded":
            params = dict(zip(sorted(whole), tp.shard_params(
                [(k, whole[k]) for k in sorted(whole)], mesh)))
        init_states, _ = parallel.tree_optimizer_step(adam)
        states = init_states(params)
        step = parallel.build_train_step(loss_fn, adam, **kw)
        losses = []
        for i in range(2):
            params, states, loss = step(params, states, 1 + i, None, batch)
            losses.append(loss.clone())
        runs[tag] = (params, losses)
    (pu, lu), (ps, ls) = runs["unsharded"], runs["sharded"]
    equal = all(torch.equal(a, b) for a, b in zip(lu, ls)) and all(
        torch.equal(pu[k], ps[k]) for k in pu)
    print("model parallel: build_train_step(param_spec=%s) on %s, 2 Adam "
          "steps of a GPT-2 FFN (%d x %d, %d tokens): losses %s, equal to "
          "the unsharded step's bit for bit: %s" % (
              {k: tuple(v) for k, v in specs.items()}, mesh.shape, C, Hd, N,
              [float(x) for x in ls], equal), flush=True)
    check(any(tuple(s) for s in specs.values()),
          "no spec split anything: the gather and scatter went unexercised")
    check(equal, "build_train_step(param_spec=) at tp=1 differs from the "
          "unsharded step")
    return {"specs": {k: list(v) for k, v in specs.items()},
            "losses": [float(x) for x in ls], "bitwise": equal}


def _moe_plain(x, rw, w1, w2, capacity):
    """Top-1 routing with the capacity, each expert's kept tokens through
    its FFN in fp32, scaled by the gate: moe_ffn's math without the
    one-hot dispatch."""
    import torch

    # the routing as moe_ffn computes it (the logits in x's dtype), so a
    # near tie goes the same way
    probs = torch.softmax(x @ rw, dim=-1)
    expert = torch.argmax(probs, dim=-1)
    gate = probs.amax(dim=-1).float()
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(rw.shape[1]):
        idx = torch.nonzero(expert == e).flatten()[:capacity]
        h = torch.relu(x[idx].float() @ w1[e].float())
        y[idx] = (h @ w2[e].float()) * gate[idx, None]
    return y


def _moe_ep1(dev):
    import torch
    from mxnet_tpu_torch import parallel

    mesh = parallel.make_mesh({"ep": 1})
    C, E, Hd, N = (MOE[k] for k in ("units", "experts", "hidden", "tokens"))
    g = torch.Generator(device=dev).manual_seed(SEED + 47)
    x = torch.randn(N, C, device=dev, generator=g).to(torch.bfloat16)
    rw = (torch.randn(C, E, device=dev, generator=g) * 0.05).to(
        torch.bfloat16)
    w1 = (torch.randn(E, C, Hd, device=dev, generator=g) * 0.02).to(
        torch.bfloat16)
    w2 = (torch.randn(E, Hd, C, device=dev, generator=g) * 0.02).to(
        torch.bfloat16)
    y, aux = parallel.moe_ffn(x, rw, w1, w2, mesh,
                              capacity_factor=MOE["capacity_factor"])
    cap = max(1, int(MOE["capacity_factor"] * N / E))
    ref = _moe_plain(x, rw, w1, w2, cap)
    rel = _rel(y, ref)
    counts = torch.bincount(torch.argmax(torch.softmax(x @ rw, -1), -1),
                            minlength=E).tolist()
    # one_hot checks its indices on the host: no graph capture, events

    def moe():
        return parallel.moe_ffn(x, rw, w1, w2, mesh,
                                capacity_factor=MOE["capacity_factor"])

    moe()
    ms = device_step_ms(moe, 5)[0]
    print("model parallel: moe_ffn ep=1, %d tokens of %d, %d experts of "
          "hidden %d, capacity %d (tokens an expert %s): relative L2 to the "
          "plain fp32 math %.3g (limit %g), aux %.4f; %.3f ms (%s)" % (
              N, C, E, Hd, cap, counts, rel, MOE_REL_TOL, float(aux), ms,
              card_line()), flush=True)
    check(bool(torch.isfinite(y).all()), "moe_ffn: non-finite output")
    check(rel <= MOE_REL_TOL, "moe_ffn disagrees with its plain math: %.3g"
          % rel)
    return {"rel_l2": rel, "aux": float(aux), "capacity": cap,
            "tokens_per_expert": counts, "ms": ms}


def _pipe_pp1(dev):
    """pipeline_train_step_1f1b at pp = 1 over PIPE["micro"] microbatches
    of one GPT-2 block (fp32), against the same microbatches' losses and
    gradients accumulated without the schedule."""
    import torch
    from mxnet_tpu_torch import autograd, parallel
    from mxnet_tpu_torch.gluon.block import _param_store
    from mxnet_tpu_torch.models.gpt import GPTModel

    mesh = parallel.make_mesh({"pp": 1})
    model = GPTModel(**dict(GPT_CONFIG, num_layers=1))
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 53))
    block = model.blocks[0]
    plist = list(block.collect_params().values())
    names = [p.name for p in plist]
    M, Bm, T = PIPE["micro"], PIPE["batch"], PIPE["seq"]
    C = GPT_CONFIG["units"]
    g = torch.Generator(device=dev).manual_seed(SEED + 59)
    xs = torch.randn(M, Bm, T, C, device=dev, generator=g)
    tg = torch.randn(M, Bm, T, C, device=dev, generator=g)

    def stage_fn(params, x):
        prev = getattr(_param_store, "params", None)
        _param_store.params = {id(p): params[nm] for p, nm in zip(plist,
                                                                    names)}
        try:
            with autograd.record(train_mode=False):
                return block(x)
        finally:
            _param_store.params = prev

    def mse(y, t):
        return ((y - t) ** 2).mean()

    stacked = {nm: p._tensor().detach()[None] for p, nm in zip(plist, names)}
    reset_counters()
    loss, grads = parallel.pipeline_train_step_1f1b(stage_fn, mse, stacked,
                                                    xs, tg, mesh)
    torch.cuda.synchronize()
    launches = read_counters()
    live = {nm: p._tensor().detach().clone().requires_grad_(True)
            for p, nm in zip(plist, names)}
    ref_loss = torch.zeros((), device=dev)
    for m in range(M):
        lv = mse(stage_fn(live, xs[m]), tg[m])
        (lv / M).backward()
        ref_loss = ref_loss + lv.detach()
    ref_loss = ref_loss / M
    worst = max(_rel(grads[nm][0], live[nm].grad) for nm in names)
    bitwise = all(torch.equal(grads[nm][0], live[nm].grad) for nm in names)
    lrel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    print("model parallel: 1F1B at pp=1 over %d microbatches of (%d, %d, "
          "%d) through one GPT-2 block (fp32): loss %.6f vs %.6f unscheduled "
          "(relative %.3g), worst gradient relative L2 %.3g (limit %g), bit "
          "for bit %s; launches %s" % (
              M, Bm, T, C, float(loss), float(ref_loss), lrel, worst,
              PIPE_REL_TOL, bitwise, {k: v for k, v in launches.items() if v}),
          flush=True)
    check(lrel <= PIPE_REL_TOL and worst <= PIPE_REL_TOL,
          "1F1B at pp=1 differs from the unscheduled step")
    return {"loss": float(loss), "loss_rel": lrel, "worst_grad_rel_l2": worst,
            "bitwise": bitwise, "launches": launches}


def _sync_bn_dp1(dev):
    import torch
    from mxnet_tpu_torch import autograd, parallel
    from mxnet_tpu_torch.gluon.contrib.nn import SyncBatchNorm
    from mxnet_tpu_torch.gluon.nn import BatchNorm

    mesh = parallel.make_mesh({"dp": 1})
    g = torch.Generator(device=dev).manual_seed(SEED + 61)
    x = torch.randn(SYNC_BN_SHAPE, device=dev, generator=g).to(
        torch.bfloat16)
    w = torch.randn(x.shape, device=dev, generator=g).to(torch.bfloat16)
    C = SYNC_BN_SHAPE[1]
    got = []
    for bn in (BatchNorm(in_channels=C), SyncBatchNorm(in_channels=C,
                                                       mesh=mesh)):
        bn.initialize(device=dev)
        xi = x.clone().requires_grad_(True)
        with autograd.record():
            y = bn(xi)
        (y.float() * w.float()).sum().backward()
        got.append([y.detach(), xi.grad, bn.gamma._tensor().grad,
                    bn.beta._tensor().grad, bn.running_mean._tensor().clone(),
                    bn.running_var._tensor().clone()])
    equal = all(torch.equal(a, b) for a, b in zip(*got))
    print("model parallel: SyncBatchNorm at dp=1 on %s bf16: output, dx, "
          "dgamma, dbeta and running statistics equal to BatchNorm's bit for "
          "bit: %s" % (tuple(x.shape), equal), flush=True)
    check(equal, "SyncBatchNorm at dp=1 differs from BatchNorm")
    return {"bitwise": equal}


def phase_model_parallel(dev):
    """A.12's model-parallel half on one card, over an NCCL group of one
    rank: the GPT-2 small step inside sequence_parallel_scope (ring and
    Ulysses at sp = 1) against the plain step; the n = 4 ring replayed on
    the card against the whole-sequence flash kernel; build_train_step
    with TRANSFORMER_RULES specs at tp = 1, moe_ffn at ep = 1, 1F1B at
    pp = 1 and SyncBatchNorm at dp = 1 against their plain forms."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    distributed.init_process_group(device=dev)
    out = {"card": card_line(), "backend": torch.distributed.get_backend()}
    try:
        out["gpt2_sp1"] = _sp_gpt(dev, parallel.make_mesh({"sp": 1}))
        torch.cuda.empty_cache()
        out["ring_n4"] = _ring_n4(dev)
        torch.cuda.empty_cache()
        out["tp_step"] = _ffn_step_equal(dev, parallel.make_mesh(
            {"dp": 1, "tp": 1}))
        out["moe_ep1"] = _moe_ep1(dev)
        torch.cuda.empty_cache()
        out["pipeline_pp1"] = _pipe_pp1(dev)
        out["sync_bn_dp1"] = _sync_bn_dp1(dev)
        torch.cuda.empty_cache()
    finally:
        distributed.shutdown()
    out["phase_seconds"] = time.perf_counter() - t_phase
    print("model parallel phase: %.1f s on %s" % (out["phase_seconds"],
                                                  out["card"]), flush=True)
    return out


# Megatron compute sharding replayed on one card (tensor_parallel.tp_scope
# .replay): GPT-2 small's forward and backward at tp = 4, every rank's
# share on the card, the regions' sums over the replayed ranks
TP_REPLAY = 4
# the split step against an fp32 reference: the loss, the logits and each
# gradient no more than this many times as far (relative L2) as the
# unsplit bf16 step's own
TP_ERR_RATIO = 2.0
# BERT-base's MLM head at tp = 2: the vocabulary-parallel loss over the
# two (rows, 15261) halves of its 30522 logits
TP_XENT = {"rows": 1280, "vocab": VOCAB, "n": 2}


def _tp_gpt_run(model, inp, tgt, scope=None):
    """One forward and backward of ``model`` on (inp, tgt) (the per-token
    loss's mean over T a sample), inside ``scope``; returns (the per-sample
    loss, the logits, each parameter's gradient, the launches)."""
    import contextlib

    import torch
    from mxnet_tpu_torch import autograd, gluon

    params = list(model.collect_params().values())
    for p in params:
        p.zero_grad()
    torch.cuda.synchronize()
    reset_counters()
    with autograd.record(train_mode=False):
        with scope if scope is not None else contextlib.nullcontext():
            logits = model(inp)
            loss = gluon.loss.SoftmaxCrossEntropyLoss()(logits, tgt)
    autograd.backward(loss)
    torch.cuda.synchronize()
    launches = read_counters()
    return (loss.detach(), logits.detach(), _grads(params), launches)


def _tp_ratio_reading(got, base, ref, names):
    """{name: [the unsplit bf16 step's relative L2 to the fp32 reference,
    the split step's, their ratio]} over loss, logits and gradients."""
    out = {}
    for nm, g, b, r in zip(names, got, base, ref):
        eb, eg = _rel(b, r), _rel(g, r)
        out[nm] = [eb, eg, eg / eb if eb > 0 else (0.0 if eg == 0 else
                                                   float("inf"))]
    return out


def _tp_gpt_replay(dev):
    """GPT-2 small's forward and backward at tp = 4 replayed on one card
    (bf16, batch GPT_TRAIN, no dropout): 3 local heads of 12 a rank, the
    FFN's 768 of 3072 columns, the vocabulary (50257) whole, against the
    unsplit bf16 step and an fp32 reference on the plain versions."""
    import torch
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch.models.gpt import GPTModel
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    cfg = dict(GPT_CONFIG, dropout=0.0)
    model = GPTModel(**cfg)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED + 71))
    amp.convert_hybrid_block(model, "bfloat16")
    params = list(model.collect_params().values())
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    seq = np.random.default_rng(SEED + 71).integers(
        0, cfg["vocab_size"], (B, T + 1)).astype(np.int32)
    inp = torch.from_numpy(np.ascontiguousarray(seq[:, :T])).to(dev)
    tgt = torch.from_numpy(np.ascontiguousarray(seq[:, 1:])).to(dev)

    class Axis:
        shape = {"tp": TP_REPLAY}

    specs = [(p._tensor(), tp.spec_for(p.name, tuple(p.shape),
                                       tp.TRANSFORMER_RULES, Axis))
             for p in params]
    n_split = sum(1 for _, sp in specs if tuple(sp))
    base = _tp_gpt_run(model, inp, tgt)
    tp.reset_counters()
    got = _tp_gpt_run(model, inp, tgt, tp.tp_scope.replay(TP_REPLAY, specs))
    paths = dict(tp.counters)
    ref32 = GPTModel(**cfg)
    ref32.initialize(device=dev)
    with torch.no_grad():
        for p, q in zip(ref32.collect_params().values(), params):
            p._tensor().copy_(q._tensor().float())
    with plain_versions():
        ref = _tp_gpt_run(ref32, inp, tgt)
    del ref32
    names = ["loss", "logits"] + [p.name for p in params]
    reading = _tp_ratio_reading([got[0], got[1]] + got[2],
                                [base[0], base[1]] + base[2],
                                [ref[0], ref[1]] + ref[2], names)
    del base, ref
    torch.cuda.empty_cache()
    worst = max(reading.items(), key=lambda kv: kv[1][2])
    hl = cfg["num_heads"] // TP_REPLAY
    want = {"flash_attention_fwd": TP_REPLAY * cfg["num_layers"],
            "flash_attention_bwd": TP_REPLAY * cfg["num_layers"],
            "layernorm": 2 * cfg["num_layers"] + 1,
            "layernorm_bwd": 2 * cfg["num_layers"] + 1,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1}
    launches = got[3]
    flash_ms = _local_head_flash_ms(dev, B, T, cfg["num_heads"], hl,
                                    cfg["units"] // cfg["num_heads"])
    print("tp compute: gpt2 small forward and backward at tp=%d replayed "
          "on one card (%d x %d bf16, %d local heads of %d, flash at %s, "
          "%d split leaves): relative L2 to fp32 (unsplit, split, ratio) "
          "loss %s, logits %s, worst %s %s (limit %gx); paths %s; launches "
          "%s" % (TP_REPLAY, B, T, hl, cfg["num_heads"], (B, hl, T,
                                                         cfg["units"]
                                                         // cfg["num_heads"]),
                  n_split, ["%.3g" % x for x in reading["loss"]],
                  ["%.3g" % x for x in reading["logits"]], worst[0],
                  ["%.3g" % x for x in worst[1]], TP_ERR_RATIO, paths,
                  {k: v for k, v in launches.items() if v}), flush=True)
    # the attentions and FFNs split; the embedding and the tied head too
    # when the axis divides the vocabulary (GPT-2's 50257 it does not)
    vocab_split = cfg["vocab_size"] % TP_REPLAY == 0
    check(paths["gathered"] == 0 and paths["gathered_leaves"] == 0
          and paths["split"] == 2 * cfg["num_layers"] + 2 * vocab_split,
          "tp=%d replay: blocks took the gathered path: %s"
          % (TP_REPLAY, paths))
    check(all(v[2] <= TP_ERR_RATIO for v in reading.values()),
          "tp=%d replay: farther than %gx the unsplit step's error from "
          "fp32: %s %s" % (TP_REPLAY, TP_ERR_RATIO, worst[0], worst[1]))
    for name, n in want.items():
        check(launches[name] == n, "tp=%d replay: %s launches %d != %d"
              % (TP_REPLAY, name, launches[name], n))
    return {"errors": reading, "worst": list(worst), "paths": paths,
            "launches": launches, "split_leaves": n_split,
            "local_heads": hl, "flash_ms": flash_ms}


def _local_head_flash_ms(dev, B, T, H, hl, D):
    """Device ms (graph replay) of the causal flash forward with the lse
    and of the backward at a rank's H/n heads and at all H heads."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(SEED + 79)
    out = {}
    for h in (hl, H):
        q, k, v, do = (torch.randn(B, h, T, D, device=dev, generator=g).to(
            torch.bfloat16) for _ in range(4))
        o, lse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
        delta = (o.float() * do.float()).sum(dim=-1)
        fwd, bwd = time_ms(
            lambda: fa.flash_attention(q, k, v, causal=True,
                                       return_lse=True),
            lambda: fa.flash_attention_bwd(q, k, v, do, lse, delta,
                                           causal=True))
        out["%d_heads" % h] = {"forward": fwd, "backward": bwd}
    print("tp compute: causal flash at (%d, h, %d, %d), device ms by graph "
          "replay: %s, on %s" % (B, T, D, out, card_line()), flush=True)
    return out


def forgot_last_lse(losses, lses):
    """A vocabulary merge that leaves the last rank's lse out (planted)."""
    import torch

    lse = torch.logsumexp(torch.stack(lses[:-1]), dim=0)
    picked = sum(a - b for a, b in zip(lses, losses))
    return lse - picked, lse


def _tp_xent(dev):
    """BERT-base's MLM head at tp = 2: the vocabulary-parallel loss and dx
    over the two halves of (rows, 30522) bf16 logits against the unsplit
    kernel, both held to an fp64 reference; a merge that forgets the last
    rank's lse (planted) must be caught."""
    import torch
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    R, V, n = TP_XENT["rows"], TP_XENT["vocab"], TP_XENT["n"]
    g = torch.Generator(device=dev).manual_seed(SEED + 73)
    x = (torch.randn(R, V, device=dev, generator=g) * 3).to(torch.bfloat16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int32)
    dy = torch.rand(R, device=dev, generator=g)
    size = V // n
    parts = [x[:, r * size:(r + 1) * size].contiguous() for r in range(n)]
    xd = x.double()
    lse_ref = torch.logsumexp(xd, dim=1)
    loss_ref = lse_ref - xd.gather(1, labels.long()[:, None])[:, 0]
    dx_ref = (torch.exp(xd - lse_ref[:, None]) - torch.nn.functional.one_hot(
        labels.long(), V).double()) * dy.double()[:, None]
    reset_counters()
    loss_w, lse_w = sx.softmax_xent_fwd(x, labels)
    dx_w = sx.softmax_xent_bwd(x, labels, lse_w, dy)
    whole_launches = read_counters()
    torch.cuda.synchronize()

    def split(merge):
        ps = [p.clone().requires_grad_(True) for p in parts]
        loss = tp.vocab_parallel_xent(ps, labels, [r * size
                                                   for r in range(n)],
                                      merge=merge)
        loss.backward(dy)
        return loss.detach(), torch.cat([p.grad for p in ps], dim=1)

    reset_counters()
    loss_s, dx_s = split(tp.merge_xent)
    torch.cuda.synchronize()
    launches = read_counters()
    errs = {"loss": [_rel(loss_w, loss_ref), _rel(loss_s, loss_ref)],
            "dx": [_rel(dx_w, dx_ref), _rel(dx_s, dx_ref)]}
    within = {k: e[1] <= TP_ERR_RATIO * e[0] for k, e in errs.items()}
    loss_f, _ = split(forgot_last_lse)
    fault = _rel(loss_f, loss_ref)
    caught = fault > TP_ERR_RATIO * errs["loss"][0]
    labels_in = [int(((labels >= r * size) & (labels < (r + 1) * size))
                     .sum()) for r in range(n)]
    half, lab0 = parts[0], labels  # rank 0's block: no shift
    _, lse0 = sx.softmax_xent_fwd(half, lab0)
    xent_ms = dict(zip(
        ("whole_forward", "whole_backward", "block_forward",
         "block_backward"), time_ms(
            lambda: sx.softmax_xent_fwd(x, labels),
            lambda: sx.softmax_xent_bwd(x, labels, lse_w, dy),
            lambda: sx.softmax_xent_fwd(half, lab0),
            lambda: sx.softmax_xent_bwd(half, lab0, lse0, dy))))
    print("tp compute: vocabulary-parallel softmax-xent over %d x (%d of "
          "%d) bf16 (labels a block %s): relative L2 to fp64 (unsplit "
          "kernel, split) %s (limit %gx); launches %s (unsplit %s); planted "
          "merge without the last lse: loss %.3g, caught %s; device ms by "
          "graph replay %s, on %s" % (
              R, size, V, labels_in,
              {k: ["%.3g" % v for v in e] for k, e in errs.items()},
              TP_ERR_RATIO, {k: v for k, v in launches.items() if v},
              {k: v for k, v in whole_launches.items() if v}, fault, caught,
              xent_ms, card_line()), flush=True)
    check(all(within.values()), "vocabulary-parallel xent farther than %gx "
          "the unsplit kernel's error: %s" % (TP_ERR_RATIO, errs))
    check(launches["softmax_xent_fwd"] == n and launches["softmax_xent_bwd"]
          == n, "vocabulary-parallel xent: launches %s, want %d each way"
          % (launches, n))
    check(caught, "vocabulary-parallel xent: the planted merge fault passes")
    return {"errors": errs, "within": within, "launches": launches,
            "labels_a_block": labels_in, "planted_loss_rel_l2": fault,
            "planted_caught": caught, "ms": xent_ms}


def _tp_train_step(dev, mesh):
    """build_train_step with TRANSFORMER_RULES specs at {dp: 1, tp: 1} on
    the GPT-2 small step (block_loss_fn: the blocks take the split path)
    against the same step without specs, two Adam steps each, as
    ``_sp_gpt`` holds the sequence-parallel step: the first loss bit for
    bit, the parameters no dq reaches equal after the first step."""
    import torch
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch import optimizer as opt
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.parallel import tensor_parallel as tp

    step = GPTTrainStep(dev)
    loss_fn, plist = parallel.block_loss_fn(
        step.model, gluon.loss.SoftmaxCrossEntropyLoss())
    init = [p._tensor().detach().clone() for p in plist]
    specs = [tp.spec_for(p.name, tuple(p.shape), tp.TRANSFORMER_RULES, mesh)
             for p in plist]
    last = step.model.blocks[-1]
    fixed_names = {p.name for b in (last.attn.attn_out, last.ln2, last.ffn_1,
                                    last.ffn_2, step.model.ln_f)
                   for p in b.collect_params().values()}
    fixed = [i for i, p in enumerate(plist) if p.name in fixed_names]
    runs = {}
    for tag, spec in (("plain", None), ("split", specs)):
        adam = opt.Adam(**ADAM)
        params = [a.clone() for a in init]
        init_states, _ = parallel.tree_optimizer_step(adam)
        states = init_states(params)
        fn = parallel.build_train_step(loss_fn, adam, mesh=mesh,
                                       param_spec=spec)
        mx_random.seed(SEED)
        losses, snaps, launches = [], [], []
        tp.reset_counters()
        for i in range(2):
            torch.cuda.synchronize()
            reset_counters()
            params, states, loss = fn(params, states, 1 + i, None,
                                      (step.inp, step.tgt))
            torch.cuda.synchronize()
            launches.append(read_counters())
            losses.append(loss.clone())
            snaps.append([a.clone() for a in params])
        runs[tag] = (losses, snaps, launches, dict(tp.counters))
        del params, states
    (lp, sp_, _, _), (ls, ss, ln, paths) = runs["plain"], runs["split"]
    first = bool(torch.equal(lp[0], ls[0]))
    unreached = all(torch.equal(ss[0][i], sp_[0][i]) for i in fixed)
    differs = [sum(not torch.equal(a, b) for a, b in zip(x, y))
               for x, y in zip(ss, sp_)]
    print("tp compute: build_train_step(TRANSFORMER_RULES specs) on %s, the "
          "gpt2 small step through the split path (paths %s): losses %s "
          "(plain %s), first bit for bit %s; the %d parameters no dq reaches "
          "equal after the first step %s; parameters differing after each "
          "step %s (a reading); launches a step %s" % (
              mesh.shape, paths, [float(x) for x in ls],
              [float(x) for x in lp], first, len(fixed), unreached, differs,
              ln[0]), flush=True)
    check(paths["gathered"] == 0 and paths["gathered_leaves"] == 0 and
          paths["split"] == 2 * (2 * GPT_CONFIG["num_layers"] + 2),
          "tp=1 step: not every block took the split path: %s" % paths)
    check(first, "tp=1 step: the first loss is not the plain step's")
    check(unreached, "tp=1 step: a parameter no dq reaches differs from the "
          "plain step's after the first step")
    for i, got in enumerate(ln):
        for name, n in GPT_STEP_LAUNCHES.items():
            check(got[name] == n, "tp=1 step %d: %s launches %d != %d"
                  % (i, name, got[name], n))
    del step, runs
    return {"paths": paths, "first_loss_bitwise": first,
            "unreached_equal": unreached, "differs": differs,
            "losses": [float(x) for x in ls], "launches": ln}


def phase_tp_compute(dev):
    """A.12's last item on one card: Megatron compute sharding, the GPT-2
    small step replayed at tp = 4, BERT-base's MLM head through the
    vocabulary-parallel loss at tp = 2, and build_train_step's split path
    at {dp: 1, tp: 1} over an NCCL group of one rank against the plain
    step."""
    import torch
    from mxnet_tpu_torch import parallel
    from mxnet_tpu_torch.parallel import distributed

    t_phase = time.perf_counter()
    out = {"card": card_line()}
    out["gpt2_tp4_replay"] = _tp_gpt_replay(dev)
    torch.cuda.empty_cache()
    out["bert_mlm_xent_tp2"] = _tp_xent(dev)
    torch.cuda.empty_cache()
    distributed.init_process_group(device=dev)
    try:
        out["train_step_tp1"] = _tp_train_step(
            dev, parallel.make_mesh({"dp": 1, "tp": 1}))
    finally:
        distributed.shutdown()
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    print("tp compute phase: %.1f s on %s" % (out["phase_seconds"],
                                              out["card"]), flush=True)
    return out


HYB_STEPS = 3


class _LMLoss:
    """GPT_TRAIN's step as a Gluon user writes it: one HybridBlock holding
    the model and its loss (``hybrid_forward`` returns the per-sample
    loss), a Trainer over the model's parameters."""

    def __init__(self, dev):
        from mxnet_tpu_torch import gluon
        from mxnet_tpu_torch.gluon.block import HybridBlock

        base = GPTTrainStep(dev)

        class Net(HybridBlock):
            def __init__(self, model, loss):
                super().__init__(prefix="lmloss_")
                self.model, self.loss = model, loss

            def hybrid_forward(self, F, x, y):
                return self.loss(self.model(x), y)

        self.model, self.inp, self.tgt = base.model, base.inp, base.tgt
        self.net = Net(base.model, gluon.loss.SoftmaxCrossEntropyLoss())
        self.params = base.params
        self.trainer = None
        self.gluon = gluon

    def fresh_trainer(self, init):
        import torch

        with torch.no_grad():
            for p, s in zip(self.params, init):
                p._tensor().copy_(s)
        self.trainer = self.gluon.Trainer(self.model.collect_params(),
                                          "adam", dict(ADAM))

    def __call__(self):
        from mxnet_tpu_torch import autograd, nd

        x, y = nd.NDArray(self.inp), nd.NDArray(self.tgt)
        with autograd.record():
            loss = self.net(x, y)
        loss.backward()
        self.trainer.step(GPT_TRAIN["batch"])
        return loss._data.detach()


def _hyb_run(step, init, n, hybrid):
    """``n`` steps from ``init`` with a fresh Adam trainer, the generators
    seeded once; per step the loss, the launches and the host wall, the
    parameters after each step, and the first step's gradients."""
    import torch
    from mxnet_tpu_torch import random as mx_random

    step.fresh_trainer(init)
    step.net.hybridize(active=hybrid)
    mx_random.seed(SEED)
    rows, snaps = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        rows.append({"loss": loss.clone(), "launches": read_counters(),
                     "host_wall_ms": (time.perf_counter() - t0) * 1e3})
        snaps.append(_param_snapshot(step))
        if len(rows) == 1:
            grads = _grads(step.params)
    return rows, snaps, grads


HYB_OPT_REPS = 10


def _hyb_interleave(step):
    """Keys of one hybridized block interleaved, with the weights fixed (a
    rate of 0 set before): the batch and its first half forwarded under
    one ``record``, a predict call on its first quarter between those
    forwards and the one backward; eager, then hybridized twice, the
    generators seeded alike before each run. Returns each run's losses,
    gradients and the block's counts in it. Each program has a memory
    pool of its own, so no key's graph may overwrite another's saved
    activations, and ``random.seed`` drops the programs, so the second
    hybridized run draws the first's masks."""
    import torch
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch import random as mx_random

    b = GPT_TRAIN["batch"]
    x, y = step.inp, step.tgt

    def once():
        before = step.net.hybrid_stats()
        mx_random.seed(SEED)
        with autograd.record():
            la = step.net(nd.NDArray(x), nd.NDArray(y))
            lb = step.net(nd.NDArray(x[:b // 2]), nd.NDArray(y[:b // 2]))
        q = max(1, b // 4)
        step.net(nd.NDArray(x[:q]), nd.NDArray(y[:q]))  # a predict key
        autograd.backward([la, lb])
        torch.cuda.synchronize()
        return {"losses": [la._data.detach().clone(),
                           lb._data.detach().clone()],
                "grads": _grads(step.params),
                "stats": {k: v - before[k]
                          for k, v in step.net.hybrid_stats().items()}}

    step.net.hybridize(active=False)
    runs = [once()]
    step.net.hybridize()
    runs += [once(), once()]
    return runs


def _optimizer_program_reading(step, dev):
    """The GPT-2 step's Adam update (``ADAM``, fp32 masters) on clones of
    the weights and gradients: eager (``fused_update``) against the step
    program's graph replay (``optimizer.StepProgram``), each timed by CUDA
    events over HYB_OPT_REPS runs back to back after one more. A reading
    (None on the CPU)."""
    import torch
    from mxnet_tpu_torch import optimizer as opt_mod

    if dev.type != "cuda":
        return None
    ws = [p._tensor().detach().clone() for p in step.params]
    gs = [p._tensor().grad.detach().clone() for p in step.params]
    idx = list(range(len(ws)))
    out = {}
    for label in ("eager", "program"):
        opt = opt_mod.Adam(**ADAM)
        states = [opt.create_state(i, w) for i, w in zip(idx, ws)]
        if label == "eager":
            def run():
                opt.fused_update(ws, gs, states, idx)
        else:
            prog = opt_mod.StepProgram(opt)
            prog.run(ws, gs, states, idx)
            run = prog.graph.replay
        run()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(HYB_OPT_REPS):
            run()
        t1.record()
        t1.synchronize()
        out[label + "_ms"] = t0.elapsed_time(t1) / HYB_OPT_REPS
        del states
    out["groups"] = len(prog._groups)
    return out


def phase_hybridize(dev):
    """A.13's capture on the GPT-2 small step at GPT_TRAIN's recipe (8 x
    1024, bf16, dropout 0.1, Adam): ``net.hybridize()``,
    ``autograd.record``, ``loss.backward()``, ``trainer.step``, against
    the eager step from the same weights and generators: the first loss
    bit for bit, the parameters no dq reaches equal after the first step,
    the first step's gradients within GPT-2's limits of the eager step's
    (beside a second eager run's reading), the launches a step the eager
    step's, one forward, backward and optimizer capture and no recapture;
    then a learning rate of 0 set after capture (the weights stay) and two
    replays on the same weights and batch (new dropout masks: the losses
    differ); then the keys interleaved (:func:`_hyb_interleave`: losses
    bit for bit the eager ones and, seeded again, the first hybridized
    run's, after a drop and 3 recaptures; gradients within GPT-2's limits
    of the eager ones; 3 forward and 2 backward captures and replays),
    and the Adam update eager against its step program (a reading). The
    count of parameters that differ from the eager run's
    after HYB_STEPS steps is a reading beside a second eager run's: the
    flash dq sums in no fixed order, the count sits near all 148 and moves
    by one or two from a run to the next, so one exchangeable sample is
    no bound on another (146 against 145, 148 against 146 on an H100)."""
    import torch

    t_phase = time.perf_counter()
    step = _LMLoss(dev)
    init = _param_snapshot(step)
    last = step.model.blocks[-1]
    names = {p.name for b in (last.attn.attn_out, last.ln2, last.ffn_1,
                              last.ffn_2, step.model.ln_f)
             for p in b.collect_params().values()}
    fixed = [i for i, p in enumerate(step.params) if p.name in names]
    eager, ref, ref_grads = _hyb_run(step, init, HYB_STEPS, False)
    _, again, again_grads = _hyb_run(step, init, HYB_STEPS, False)
    own = _params_gap(again[-1], ref[-1])[1]
    own_grads = _grad_reading(step, again_grads, ref_grads)
    del again, again_grads
    rows, snaps, grads = _hyb_run(step, init, HYB_STEPS, True)
    grad_reading = _grad_reading(step, grads, ref_grads)
    del grads, ref_grads
    stats, gstats = step.net.hybrid_stats(), step.trainer.graph_stats()
    gap = _params_gap(snaps[-1], ref[-1])[1]
    first = bool(torch.equal(rows[0]["loss"], eager[0]["loss"]))
    unreached = all(torch.equal(snaps[0][i], ref[0][i]) for i in fixed)
    before = snaps[-1]
    del snaps, ref
    step.trainer.set_learning_rate(0.0)
    extra = []
    for _ in range(2):
        reset_counters()
        extra.append(step())
    torch.cuda.synchronize()
    after = _param_snapshot(step)
    lr_took = all(torch.equal(a, b) for a, b in zip(after, before))
    masks_differ = not torch.equal(extra[0], extra[1])
    stats_end = step.net.hybrid_stats()
    gstats_end = step.trainer.graph_stats()
    inter = _hyb_interleave(step)
    e, h1, h2 = inter
    inter_out = {
        "losses_bitwise": all(torch.equal(a, b) for a, b in zip(
            h1["losses"], e["losses"])),
        "seeded_again_bitwise": all(torch.equal(a, b) for a, b in zip(
            h2["losses"], h1["losses"])),
        "grads": _grad_reading(step, h1["grads"], e["grads"]),
        "grads_seeded_again": _grad_reading(step, h2["grads"], e["grads"]),
        "stats": h1["stats"], "stats_seeded_again": h2["stats"]}
    del inter, e, h1, h2
    opt_reading = _optimizer_program_reading(step, dev)
    step.net.hybridize(active=False)
    wall_e = float(np.median([r["host_wall_ms"] for r in eager[1:]]))
    wall_h = float(np.median([r["host_wall_ms"] for r in rows[1:]]))
    out = {"card": card_line(), "first_loss_bitwise": first,
           "unreached_equal": unreached, "differs": gap,
           "second_eager_run_differs": own, "grads": grad_reading,
           "second_eager_run_grads": own_grads,
           "losses": [float(r["loss"].mean()) for r in rows],
           "eager_losses": [float(r["loss"].mean()) for r in eager],
           "launches": [r["launches"] for r in rows],
           "block_stats": stats, "trainer_stats": gstats,
           "block_stats_end": stats_end, "trainer_stats_end": gstats_end,
           "lr_change_took": lr_took, "replay_masks_differ": masks_differ,
           "host_wall_ms_median": {"eager": wall_e, "hybridized": wall_h},
           "interleaved": inter_out, "optimizer_update_ms": opt_reading}
    print("hybridize: gpt2 small step (%s): losses %s (eager %s), first bit "
          "for bit %s; the %d parameters no dq reaches equal after the first "
          "step %s; first step's gradients vs eager: worst %.3g, worst row "
          "%.3g (a second eager run's %.3g, %.3g; limits %g, %g); parameters "
          "differing after %d steps %d (a second eager run's %d, a "
          "reading); block %s, trainer %s; lr 0 after capture kept the "
          "weights %s; two replays on the same weights, losses %.6f and %.6f "
          "(masks differ %s); host wall a step (median of %d) eager %.3f ms, "
          "hybridized %.3f ms, a reading on %s" % (
              GPT_TRAIN, ["%.5f" % x for x in out["losses"]],
              ["%.5f" % x for x in out["eager_losses"]], first, len(fixed),
              unreached, grad_reading["worst_grad_rel_l2"],
              grad_reading["worst_row_rel_l2"],
              own_grads["worst_grad_rel_l2"], own_grads["worst_row_rel_l2"],
              GPT_STEP_GRAD_TOL, GPT_STEP_ROW_TOL, HYB_STEPS, gap, own,
              stats, gstats, lr_took,
              float(extra[0].mean()), float(extra[1].mean()), masks_differ,
              HYB_STEPS - 1, wall_e, wall_h, out["card"]), flush=True)
    check(first, "hybridize: the first loss is not the eager step's")
    check(unreached, "hybridize: a parameter no dq reaches differs from the "
          "eager step's after the first step")
    check(grad_reading["within"], "hybridize: the first step's gradients "
          "outside GPT-2's limits of the eager step's: %s" % grad_reading)
    for i, got in enumerate(out["launches"]):
        for name, n in GPT_STEP_LAUNCHES.items():
            check(got[name] == n, "hybridize step %d: %s launches %d != %d"
                  % (i, name, got[name], n))
    check(stats["forward_captures"] == 1 and stats["backward_captures"] == 1
          and stats["recaptures"] == 0 and stats["forward_replays"] ==
          HYB_STEPS and stats["backward_replays"] == HYB_STEPS,
          "hybridize: block programs %s" % stats)
    check(gstats == {"captures": 1, "replays": HYB_STEPS, "recaptures": 0},
          "hybridize: optimizer program %s" % gstats)
    check(stats_end["recaptures"] == 0 and gstats_end["recaptures"] == 0,
          "hybridize: recaptured after the lr change: %s %s"
          % (stats_end, gstats_end))
    check(lr_took, "hybridize: a learning rate of 0 set after capture did "
          "not stop the update")
    check(masks_differ, "hybridize: two replays drew the same dropout masks")
    si, s2 = inter_out["stats"], inter_out["stats_seeded_again"]
    print("hybridize: keys interleaved (the batch and its half recorded, a "
          "predict call on a quarter before the one backward): losses bit "
          "for bit the eager ones %s, seeded again bit for bit %s; "
          "gradients vs eager: worst %.3g, worst row %.3g (seeded again "
          "%.3g, %.3g); block counts in the runs %s, %s; Adam update on "
          "%s: %s" % (
              inter_out["losses_bitwise"], inter_out["seeded_again_bitwise"],
              inter_out["grads"]["worst_grad_rel_l2"],
              inter_out["grads"]["worst_row_rel_l2"],
              inter_out["grads_seeded_again"]["worst_grad_rel_l2"],
              inter_out["grads_seeded_again"]["worst_row_rel_l2"], si, s2,
              out["card"], opt_reading), flush=True)
    check(inter_out["losses_bitwise"], "hybridize: interleaved keys' losses "
          "are not the eager ones")
    check(inter_out["grads"]["within"] and
          inter_out["grads_seeded_again"]["within"],
          "hybridize: interleaved keys' gradients outside GPT-2's limits of "
          "the eager ones: %s" % inter_out)
    check((si["forward_captures"], si["backward_captures"],
           si["forward_replays"], si["backward_replays"]) == (3, 2, 3, 2),
          "hybridize: interleaved keys' programs %s" % si)
    check(inter_out["seeded_again_bitwise"] and s2["drops"] == 1
          and s2["recaptures"] == s2["forward_captures"] == 3,
          "hybridize: random.seed did not drop the programs (%s then %s) or "
          "the masks differ" % (si, s2))
    del step
    torch.cuda.empty_cache()
    out["phase_seconds"] = time.perf_counter() - t_phase
    print("hybridize phase: %.1f s on %s" % (out["phase_seconds"],
                                             out["card"]), flush=True)
    return out


# ------------------------------------- A.13 closed and A.14's symbolic core
# the kernels as torch.library ops at this slice's shapes: LayerNorm rows
# of BERT-base serving (8 x 512 = 4096) and of the GPT-2 step (8 x 1024 =
# 8192) at 768; the GPT-2 step's (8192, 50257) logits; the flash forward
# at BERT-base serving's (8, 12, 512, 64) with valid lengths and the GPT-2
# step's causal (8, 12, 1024, 64) with its lse, the fp32 form at the
# serving shape, the backward at the GPT-2 step's
LIB_SERVE = {"batch": 8, "seq": 512}
LIB_VL = [512, 300, 1, 77, 511, 256, 128, 400]
# the ops opcheck holds (schema, autograd registration, fake tensors, the
# AOT dispatch with dynamic shapes), at small shapes
LIB_OPCHECK_ROWS = 64
# the 15-op chain of phase_bulk: 5 x (mul, add, tanh) on a GPT-2 step's
# activations, (8 x 1024, 768) fp32
BULK_SHAPE = (8192, 768)
# a launch-bound chain: one token's row of the same step
BULK_SMALL_SHAPE = (8, 768)
BULK_TIMED = 20
# the torch.compile backend of phase_tape_replay's GPT-2 step
COMPILE_BACKEND = "inductor"


def _lib_flash_inputs(dev, g, B, H, T, D, dtype):
    import torch

    return [(torch.randn(B, H, T, D, device=dev, generator=g) * 0.5).to(
        dtype) for _ in range(3)]


def _planted_fake_op():
    """A copy of the softmax-xent forward op whose fake gives the lse in
    bf16 (the kernel writes fp32): what opcheck's fake-tensor test is to
    catch."""
    import torch
    from mxnet_tpu_torch.ops.cuda import IMPLS

    lib = "mxnet_tpu_torch_planted::xent_fwd_wrong_fake"
    if not hasattr(_planted_fake_op, "op"):
        @torch.library.custom_op(lib, mutates_args=())
        def op(x: torch.Tensor, labels: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
            return tuple(IMPLS["softmax_xent_fwd"](x, labels))

        @op.register_fake
        def _(x, labels):
            R = x.shape[0]
            return (x.new_empty((R,), dtype=torch.float32),
                    x.new_empty((R,), dtype=torch.bfloat16))

        _planted_fake_op.op = op
    return _planted_fake_op.op


def _opcheck(op, args):
    """opcheck's verdict a test: {test: "SUCCESS" or the error's first
    line}."""
    import torch

    got = torch.library.opcheck(op, args, raise_exception=False)
    return {k: v if v == "SUCCESS" else (str(v).splitlines() or ["?"])[0]
            for k, v in got.items()}


def _lib_compiled_launches(dev, g):
    """A function of the three differentiable ops (LayerNorm, the causal
    flash forward with its backward, softmax-xent), eager and through
    ``torch.compile(fullgraph=True)`` (aot_eager: the graph is traced
    through the ops' fakes, no graph break, the ops run as they are): the
    launches of each, their losses and gradients."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    B, H, T, D, V = 2, 4, 256, 64, 1000
    x0 = torch.randn(B * T, H * D, device=dev, generator=g).to(
        torch.bfloat16)
    gamma = torch.randn(H * D, device=dev, generator=g)
    beta = torch.randn(H * D, device=dev, generator=g)
    w = (torch.randn(H * D, V, device=dev, generator=g) * 0.05).to(
        torch.bfloat16)
    labels = torch.randint(0, V, (B * T,), device=dev, generator=g)

    def f(x):
        y = ln.layernorm(x, gamma, beta, 1e-5)
        q = y.reshape(B, T, H, D).transpose(1, 2).contiguous()
        o = fa.flash_attention_with_grad(q, q, q, causal=True)
        h = o.transpose(1, 2).reshape(B * T, H * D)
        return sx.softmax_xent(h @ w, labels).mean()

    runs = {}
    for name, fn in (("eager", f), ("compiled", torch.compile(
            f, backend="aot_eager", fullgraph=True))):
        x = x0.clone().requires_grad_()
        reset_counters()
        loss = fn(x)
        loss.backward()
        torch.cuda.synchronize()
        runs[name] = {"launches": read_counters(), "loss": loss.detach(),
                      "grad": x.grad.detach()}
    return runs


def phase_library_ops(dev):
    """Each kernel entry called as its ``torch.library`` op
    (``torch.ops.mxnet_tpu_torch``) at this slice's shapes against its
    plain version; ``torch.library.opcheck`` of every op on the card;
    eager against ``torch.compile(fullgraph=True)``: the same launches; a
    planted fake that gives the lse the wrong dtype, which opcheck must
    catch."""
    import torch
    from mxnet_tpu_torch.ops.cuda import flash_attention as fa
    from mxnet_tpu_torch.ops.cuda import layernorm as ln
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    t_phase = time.perf_counter()
    ops = torch.ops.mxnet_tpu_torch
    bf16 = torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED + 181)
    readings = {}
    for R in (LIB_SERVE["batch"] * LIB_SERVE["seq"],
              GPT_TRAIN["batch"] * GPT_TRAIN["seq"]):
        x, gamma, beta = _ln_inputs(dev, g, R, 768, bf16)
        readings["layernorm_fwd (%d, 768)" % R] = held(
            ops.layernorm_fwd(x, gamma, beta, 1e-12),
            ln.layernorm_plain(x, gamma, beta, 1e-12), BF16_TOL,
            "op layernorm_fwd (%d, 768) bf16" % R)
    dy = torch.randn(R, 768, device=dev, generator=g).to(bf16)
    got = ops.layernorm_bwd(x, gamma, dy, 1e-5)
    ref = ln.layernorm_bwd_plain(x, gamma, dy, 1e-5)
    mags = layernorm_bwd_magnitudes(x, gamma, dy, 1e-5)
    for i, (n, tol) in enumerate((("dx", LN_BWD_DX_TOL["bfloat16"]),
                                  ("dgamma", LN_BWD_PARAM_TOL),
                                  ("dbeta", LN_BWD_PARAM_TOL))):
        readings["layernorm_bwd %s" % n] = held(
            got[i], ref[i], tol, "op layernorm_bwd (%d, 768) %s" % (R, n),
            mags[i])
    del x, dy, got, ref, mags
    R, V = GPT_TRAIN["batch"] * GPT_TRAIN["seq"], GPT_CONFIG["vocab_size"]
    logits = (torch.randn(R, V, device=dev, generator=g) * 2).to(bf16)
    labels = torch.randint(0, V, (R,), device=dev, generator=g,
                           dtype=torch.int64).to(torch.int32)
    loss, lse = ops.xent_fwd(logits, labels)
    ref_loss, ref_lse = sx.softmax_xent_fwd_plain(logits, labels)
    readings["xent_fwd loss"] = held(loss, ref_loss, XENT_TOL,
                                     "op xent_fwd (%d, %d) loss" % (R, V))
    readings["xent_fwd lse"] = held(lse, ref_lse, XENT_TOL,
                                    "op xent_fwd (%d, %d) lse" % (R, V))
    dyx = torch.rand(R, device=dev, generator=g)
    readings["xent_bwd"] = held(
        ops.xent_bwd(logits, labels, lse, dyx),
        sx.softmax_xent_bwd_plain(logits, labels, lse, dyx),
        XENT_DX_TOL["bfloat16"], "op xent_bwd (%d, %d) dx" % (R, V))
    del logits, labels, loss, lse, ref_loss, ref_lse, dyx
    torch.cuda.empty_cache()
    B, T = LIB_SERVE["batch"], LIB_SERVE["seq"]
    vl = torch.tensor(LIB_VL, dtype=torch.int32, device=dev)
    scale = 1.0 / 8.0
    q, k, v = _lib_flash_inputs(dev, g, B, 12, T, 64, bf16)
    out, _ = ops.flash_fwd(q, k, v, vl, scale, False, False)
    readings["flash_fwd serving"] = held(
        out, fa.flash_attention_plain(q, k, v, vl, scale, False), FLASH_TOL,
        "op flash_fwd %s vl" % ((B, 12, T, 64),),
        flash_magnitude(q, k, v, vl, False, scale))
    qf, kf, vf = (t.float() for t in (q, k, v))
    out, _ = ops.flash_fwd_f32(qf, kf, vf, vl, scale, False, False)
    readings["flash_fwd_f32 serving"] = held(
        out, fa.flash_attention_plain(qf, kf, vf, vl, scale, False),
        FLASH_F32_TOL, "op flash_fwd_f32 %s vl" % ((B, 12, T, 64),),
        flash_magnitude(qf, kf, vf, vl, False, scale))
    del q, k, v, qf, kf, vf, out
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    q, k, v = _lib_flash_inputs(dev, g, B, 12, T, 64, bf16)
    out, lse = ops.flash_fwd(q, k, v, None, scale, True, True)
    ref, ref_lse = fa.flash_attention_plain(q, k, v, None, scale, True,
                                            return_lse=True)
    readings["flash_fwd causal"] = held(
        out, ref, FLASH_TOL, "op flash_fwd %s causal" % ((B, 12, T, 64),),
        flash_magnitude(q, k, v, None, True, scale))
    readings["flash_fwd causal lse"] = held(
        lse, ref_lse, (LSE_TOL, 0.0, 0.0), "op flash_fwd causal lse")
    do = torch.randn(B, 12, T, 64, device=dev, generator=g).to(bf16)
    delta = (out.float() * do.float()).sum(dim=-1)
    got = ops.flash_bwd(q, k, v, do, lse, delta, None, scale, True)
    args = (q, k, v, do, lse, delta)
    ref = fa.flash_attention_bwd_plain(*args, None, scale, True)
    mags = flash_bwd_magnitudes(*args, vl=None, causal=True)
    for i, n in enumerate(("dq", "dk", "dv")):
        readings["flash_bwd %s" % n] = held(
            got[i], ref[i], FLASH_BWD_TOL, "op flash_bwd %s causal %s"
            % ((B, 12, T, 64), n), mags[i])
    del q, k, v, do, out, lse, delta, got, ref, mags, args
    torch.cuda.empty_cache()
    # opcheck: every op, small shapes, its differentiable inputs requiring
    # grad
    t0 = time.perf_counter()
    n = LIB_OPCHECK_ROWS
    x, gamma, beta = _ln_inputs(dev, g, n, 768, bf16)
    xg = x.clone().requires_grad_()
    lg = (torch.randn(n, 1000, device=dev, generator=g)).to(bf16)
    lab = torch.randint(0, 1000, (n,), device=dev, generator=g).to(
        torch.int32)
    _, lse = sx.softmax_xent_fwd(lg, lab)
    q, k, v = _lib_flash_inputs(dev, g, 2, 4, 256, 64, bf16)
    vl2 = torch.tensor([256, 100], dtype=torch.int32, device=dev)
    o, flse = fa.flash_attention(q, k, v, causal=True, return_lse=True)
    do = torch.randn_like(q)
    delta = (o.float() * do.float()).sum(dim=-1)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    cases = {
        "layernorm_fwd": (ln._layernorm_fwd_op, (xg, gamma, beta, 1e-5)),
        "layernorm_bwd": (ln._layernorm_bwd_op,
                          (x, gamma, torch.randn_like(x), 1e-5)),
        "xent_fwd": (sx._xent_fwd_op, (lg.clone().requires_grad_(), lab)),
        "xent_bwd": (sx._xent_bwd_op, (lg, lab, lse, torch.rand(
            n, device=dev, generator=g))),
        "flash_fwd": (fa._flash_fwd_op, (qg, kg, vg, vl2, 0.125, False,
                                         True)),
        "flash_fwd_f32": (fa._flash_fwd_f32_op, (
            q.float(), k.float(), v.float(), vl2, 0.125, True, True)),
        "flash_bwd": (fa._flash_bwd_op, (q, k, v, do, flse, delta, None,
                                         0.125, True))}
    opcheck = {name: _opcheck(op, args) for name, (op, args) in
               cases.items()}
    planted = _opcheck(_planted_fake_op(), (lg, lab))
    opcheck_s = time.perf_counter() - t0
    compiled = _lib_compiled_launches(dev, g)
    e, c = compiled["eager"], compiled["compiled"]
    out = {"card": card_line(), "held": readings, "opcheck": opcheck,
           "planted_wrong_fake_dtype": planted, "opcheck_seconds": opcheck_s,
           "launches_eager": e["launches"],
           "launches_compiled": c["launches"],
           "compiled_loss_err": max_err(c["loss"], e["loss"]),
           "compiled_grad_err": max_err(c["grad"], e["grad"]),
           "phase_seconds": time.perf_counter() - t_phase}
    print("library ops: opcheck %s (%.1f s); planted fake with a bf16 lse: "
          "%s; launches eager %s, under torch.compile(fullgraph=True) %s; "
          "compiled against eager: loss %.3g, grad %.3g; %.1f s, %s" % (
              {k: all(r == "SUCCESS" for r in v.values())
               for k, v in opcheck.items()}, opcheck_s, planted,
              e["launches"], c["launches"], out["compiled_loss_err"],
              out["compiled_grad_err"], out["phase_seconds"], out["card"]),
          flush=True)
    for name, res in opcheck.items():
        check(all(r == "SUCCESS" for r in res.values()),
              "opcheck of the %s op: %s" % (name, res))
    check(planted.get("test_faketensor", "SUCCESS") != "SUCCESS",
          "opcheck passed a fake that gives the lse in bf16: %s" % planted)
    check(e["launches"] == c["launches"] and all(
        e["launches"][k] == 1 for k in (
            "layernorm", "layernorm_bwd", "flash_attention_fwd",
            "flash_attention_bwd", "softmax_xent_fwd", "softmax_xent_bwd")),
        "library ops: launches eager %s, compiled %s" % (e["launches"],
                                                          c["launches"]))
    check(torch.equal(c["loss"], e["loss"]) and bool(
        torch.isfinite(c["grad"]).all()), "library ops: the compiled loss "
          "is not the eager one")
    return out


def _bulk_chain(x, a, s1=0.5):
    y = x
    for _ in range(5):
        y = y * a
        y = y + s1
        y = y.tanh()
    return y


def phase_bulk(dev):
    """A.13's bulk window on the card: a 15-op ``nd`` elementwise chain at
    a GPT-2 step's activation size runs as one program (one CUDA graph of
    15 kernels: one dispatch, one build), equal to the same chain op by op
    (``bulk(0)``) bit for bit; run again it builds nothing, and with new
    scalars neither; the host wall of the chain both ways and the build's
    wall are readings, at BULK_SMALL_SHAPE (launch-bound) too: they decide
    the window's default (``engine.DEFAULT_BULK_SIZE``, ROADMAP.md C.2)."""
    import torch
    from mxnet_tpu_torch import engine, nd
    from mxnet_tpu_torch.context import context_from_device

    ctx = context_from_device(dev)
    rng = np.random.default_rng(SEED + 191)
    x = nd.array(rng.normal(size=BULK_SHAPE).astype(np.float32), ctx=ctx)
    a = nd.array(rng.uniform(0.5, 1.5, BULK_SHAPE).astype(np.float32),
                 ctx=ctx)
    with engine.bulk(0):
        engine.dispatch_counter.reset()
        ref = _bulk_chain(x, a)._data
        ref2 = _bulk_chain(x, a, 0.25)._data
        eager_dispatches = engine.dispatch_counter.count
    torch.cuda.synchronize()
    with engine.bulk(15):
        engine.dispatch_counter.reset()
        engine.bulk_compile_counter.reset()
        t0 = time.perf_counter()
        y = _bulk_chain(x, a)
        got = y._data
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        first = (engine.dispatch_counter.count,
                 engine.bulk_compile_counter.count)
        engine.dispatch_counter.reset()
        engine.bulk_compile_counter.reset()
        again = _bulk_chain(x, a)._data
        other = _bulk_chain(x, a, 0.25)._data
        steady = (engine.dispatch_counter.count,
                  engine.bulk_compile_counter.count)
    walls = {}
    small = [nd.array(rng.uniform(0.5, 1.5, BULK_SMALL_SHAPE).astype(
        np.float32), ctx=ctx) for _ in range(2)]
    for tag, (u, w) in (("", (x, a)), ("small_", small)):
        for size in (0, 15):
            with engine.bulk(size):
                _bulk_chain(u, w).wait_to_read()  # the build, untimed
                ts = []
                for _ in range(BULK_TIMED):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    _bulk_chain(u, w).wait_to_read()
                    ts.append((time.perf_counter() - t0) * 1e3)
                walls["%sbulk_%d" % (tag, size)] = float(np.median(ts))
    out = {"card": card_line(), "shape": list(BULK_SHAPE),
           "eager_dispatches_two_chains": eager_dispatches,
           "first_chain": {"dispatches": first[0], "builds": first[1],
                           "wall_ms_with_build": build_ms},
           "two_more_chains": {"dispatches": steady[0], "builds": steady[1]},
           "bitwise": bool(torch.equal(got, ref)),
           "again_bitwise": bool(torch.equal(again, ref)),
           "new_scalar_bitwise": bool(torch.equal(other, ref2)),
           "host_wall_ms_median": walls}
    print("bulk: a 15-op chain at %s: first run %d dispatch, %d build "
          "(%.2f ms with the build); two more (one with new scalars) %d "
          "dispatches, %d builds; bit for bit the op-by-op chain %s, %s, "
          "%s; host wall a chain (median of %d) op by op %.3f ms, one "
          "program %.3f ms; at %s op by op %.3f ms, one program %.3f ms; "
          "%s" % (
              BULK_SHAPE, first[0], first[1], build_ms, steady[0],
              steady[1], out["bitwise"], out["again_bitwise"],
              out["new_scalar_bitwise"], BULK_TIMED, walls["bulk_0"],
              walls["bulk_15"], BULK_SMALL_SHAPE, walls["small_bulk_0"],
              walls["small_bulk_15"], out["card"]), flush=True)
    check(eager_dispatches == 30, "bulk(0): %d dispatches for two 15-op "
          "chains" % eager_dispatches)
    check(first == (1, 1) and steady == (2, 0),
          "bulk: dispatches and builds %s then %s" % (first, steady))
    check(out["bitwise"] and out["again_bitwise"]
          and out["new_scalar_bitwise"], "bulk: the one-program chain is "
          "not the op-by-op chain")
    return out


def _grads_of(params):
    return [p._tensor().grad.detach().clone() for p in params]


def _tape_run(step, steps, compiled):
    """``steps`` NDArray steps (``_nd_step``) with the tape replay on or
    off, the generator seeded a step as phase_nd_train seeds it: per step
    the loss, the launches, the tape counters and the host wall; the first
    step's gradients."""
    import torch
    from mxnet_tpu_torch import autograd, engine, nd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.context import context_from_device

    ctx = context_from_device(step.inp.device)
    prev = autograd.set_tape_compile(compiled)
    rows, grads = [], None
    try:
        for i in range(steps):
            mx_random.seed(SEED + i)
            for c in (engine.tape_compile_counter,
                      engine.tape_cache_hit_counter,
                      engine.tape_eager_counter):
                c.reset()
            torch.cuda.synchronize()
            reset_counters()
            t0 = time.perf_counter()
            loss, mean = _nd_step(nd, step, ctx)
            torch.cuda.synchronize()
            rows.append({
                "loss": loss._data.detach(), "mean": mean,
                "launches": read_counters(),
                "tape": {"compile": engine.tape_compile_counter.count,
                         "hit": engine.tape_cache_hit_counter.count,
                         "eager": engine.tape_eager_counter.count},
                "host_wall_ms": (time.perf_counter() - t0) * 1e3})
            if i == 0:
                grads = _grads_of(step.params)
    finally:
        autograd.set_tape_compile(prev)
    return rows, grads


def _compiled_gpt_step(dev):
    """GPT-2 small's forward and loss through ``torch.compile(fullgraph=
    True)`` (``COMPILE_BACKEND``) and its backward, against the same eager:
    launches, loss, gradients, the compile's wall. Dropout 0: its masks
    come from a ``torch.Generator``, which torch.compile does not
    trace."""
    import torch
    from mxnet_tpu_torch import amp, autograd, gluon
    from mxnet_tpu_torch.models.gpt import GPTModel

    model = GPTModel(dropout=0.0, **GPT_CONFIG)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    params = list(model.collect_params().values())
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    seq = np.random.default_rng(SEED).integers(
        0, GPT_CONFIG["vocab_size"], (B, T + 1)).astype(np.int32)
    inp = torch.from_numpy(np.ascontiguousarray(seq[:, :T])).to(dev)
    tgt = torch.from_numpy(np.ascontiguousarray(seq[:, 1:])).to(dev)

    def f(x, y):
        return loss_fn(model(x), y)

    out = {}
    for name, fn in (("eager", f), ("compiled", torch.compile(
            f, backend=COMPILE_BACKEND, fullgraph=True))):
        for p in params:
            p.zero_grad()
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        with autograd.record():
            loss = fn(inp, tgt)
        autograd.backward(loss)
        torch.cuda.synchronize()
        out[name] = {"launches": read_counters(), "loss": loss.detach(),
                     "grads": _grads_of(params),
                     "first_call_s": time.perf_counter() - t0}
    e, c = out["eager"], out["compiled"]
    reading = {"launches_eager": e["launches"],
               "launches_compiled": c["launches"],
               "loss_rel_err": float((c["loss"].mean() - e["loss"].mean())
                                     .abs() / e["loss"].mean().abs()),
               "worst_grad_rel_l2": grad_rel_l2(params, c["grads"],
                                                e["grads"])[0][0],
               "worst_row_rel_l2": grad_row_rel_l2(params, c["grads"],
                                                   e["grads"])[0][0],
               "compile_and_first_step_s": c["first_call_s"],
               "eager_first_step_s": e["first_call_s"]}
    del model, out
    torch.cuda.empty_cache()
    return reading


def phase_tape_replay(dev):
    """A.13's compiled tape replay on the NDArray GPT-2 step
    (phase_nd_train's recipe: 8 x 1024, bf16, dropout 0.1, Adam): three
    steps with ``set_tape_compile(True)`` against three with the eager
    walk from the same state and seeds: the first loss bit for bit, the
    first step's gradients within GPT-2's limits, ``GPT_STEP_LAUNCHES``
    every step both ways, one tape build and then hits only; the first
    backward's build time and the host walls are readings. Then GPT-2
    small's forward and backward through ``torch.compile(fullgraph=True)``:
    no graph break at a kernel op, the eager launches, the loss within
    1e-2 of eager and the gradients within GPT-2's limits of eager's (on
    torch 2.11 they hold only because no port Function returns a tensor an
    op handed back as it was: ``base.cast_out``)."""
    import torch
    from mxnet_tpu_torch import autograd

    t_phase = time.perf_counter()
    backend = autograd.TAPE_BACKEND
    eager = GPTTrainStep(dev)
    seq = np.random.default_rng(SEED).integers(
        0, GPT_CONFIG["vocab_size"],
        (GPT_TRAIN["batch"], GPT_TRAIN["seq"] + 1)).astype(np.int32)
    for s in (eager,):
        s.inp_np = np.ascontiguousarray(seq[:, :-1])
        s.tgt_np = np.ascontiguousarray(seq[:, 1:])
    e_rows, e_grads = _tape_run(eager, GPT_TRAIN_STEPS, False)
    del eager
    torch.cuda.empty_cache()
    replay = GPTTrainStep(dev)
    replay.inp_np, replay.tgt_np = (np.ascontiguousarray(seq[:, :-1]),
                                    np.ascontiguousarray(seq[:, 1:]))
    r_rows, r_grads = _tape_run(replay, GPT_TRAIN_STEPS, True)
    grads = _grad_reading(replay, r_grads, e_grads)
    del r_grads, e_grads, replay
    torch.cuda.empty_cache()
    first = bool(torch.equal(r_rows[0]["loss"], e_rows[0]["loss"]))
    compiled = _compiled_gpt_step(dev)
    out = {"card": card_line(), "backend": backend,
           "first_loss_bitwise": first, "grads": grads,
           "losses": [r["mean"] for r in r_rows],
           "eager_losses": [r["mean"] for r in e_rows],
           "launches": [r["launches"] for r in r_rows],
           "eager_launches": [r["launches"] for r in e_rows],
           "tape": [r["tape"] for r in r_rows],
           "eager_tape": [r["tape"] for r in e_rows],
           "host_wall_ms": [r["host_wall_ms"] for r in r_rows],
           "eager_host_wall_ms": [r["host_wall_ms"] for r in e_rows],
           "torch_compile_step": compiled,
           "phase_seconds": None}
    out["phase_seconds"] = time.perf_counter() - t_phase
    print("tape replay (%s): NDArray GPT-2 step losses %s (eager walk %s), "
          "first bit for bit %s; first step's gradients vs the eager walk: "
          "worst %.3g, worst row %.3g (limits %g, %g); tape counters a step "
          "%s (eager walk %s); host wall a step %s ms (eager walk %s ms, "
          "the first with the build); launches a step %s" % (
              backend, ["%.5f" % x for x in out["losses"]],
              ["%.5f" % x for x in out["eager_losses"]], first,
              grads["worst_grad_rel_l2"], grads["worst_row_rel_l2"],
              GPT_STEP_GRAD_TOL, GPT_STEP_ROW_TOL, out["tape"],
              out["eager_tape"], ["%.1f" % w for w in out["host_wall_ms"]],
              ["%.1f" % w for w in out["eager_host_wall_ms"]],
              out["launches"][0]), flush=True)
    print("torch.compile(fullgraph=True) GPT-2 small forward and backward "
          "(dropout 0): launches %s (eager %s); loss relative %.3g, worst "
          "gradient %.3g, worst row %.3g against eager; compile and first "
          "step %.1f s (eager first step %.1f s); phase %.1f s; %s" % (
              compiled["launches_compiled"], compiled["launches_eager"],
              compiled["loss_rel_err"], compiled["worst_grad_rel_l2"],
              compiled["worst_row_rel_l2"],
              compiled["compile_and_first_step_s"],
              compiled["eager_first_step_s"], out["phase_seconds"],
              out["card"]), flush=True)
    check(first, "tape replay: the first loss is not the eager walk's")
    check(grads["within"], "tape replay: the first step's gradients "
          "outside GPT-2's limits: %s" % grads)
    for i, (got, want) in enumerate(zip(out["launches"],
                                        out["eager_launches"])):
        for name, n in GPT_STEP_LAUNCHES.items():
            check(got[name] == n and want[name] == n,
                  "tape replay step %d: %s launches %d (eager walk %d) != %d"
                  % (i, name, got[name], want[name], n))
    check(out["tape"][0] == {"compile": 1, "hit": 0, "eager": 0} and all(
        t == {"compile": 0, "hit": 1, "eager": 0} for t in out["tape"][1:]),
        "tape replay: counters %s" % out["tape"])
    check(all(t == {"compile": 0, "hit": 0, "eager": 1}
              for t in out["eager_tape"]),
          "tape replay off: counters %s" % out["eager_tape"])
    check(compiled["launches_compiled"] == compiled["launches_eager"] and
          all(compiled["launches_eager"][k] == n
              for k, n in GPT_STEP_LAUNCHES.items()),
          "torch.compile GPT-2 step: launches %s, eager %s" % (
              compiled["launches_compiled"], compiled["launches_eager"]))
    check(compiled["loss_rel_err"] <= STEP_LOSS_TOL,
          "torch.compile GPT-2 step's loss against eager: %s" % compiled)
    check(compiled["worst_grad_rel_l2"] <= GPT_STEP_GRAD_TOL
          and compiled["worst_row_rel_l2"] <= GPT_STEP_ROW_TOL,
          "torch.compile GPT-2 step's gradients against eager: %s"
          % compiled)
    return out


# path (a): BERT-base served from its export layout, one bucket of the
# export batch (the graph bakes the batch into its reshapes: ROADMAP.md C.2)
SYMBOL_SERVE_BATCH = 8
SYMBOL_INPUTS = ["data", "token_types", "valid_length"]


def _export_dir(name):
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_work", "symbol_%s" % name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def _drop_export(prefix):
    for suffix in ("-symbol.json", "-0000.params"):
        if os.path.exists(prefix + suffix):
            os.remove(prefix + suffix)


def _export_served_rows(srv, tok, tt, vl):
    """The server's outputs for every request, in groups of the bucket."""
    B = SYMBOL_SERVE_BATCH
    outs = []
    for a in range(0, len(tok), B):
        outs.append(srv.predict(tok[a:a + B], tt[a:a + B], vl[a:a + B]))
    return [np.concatenate([o[i] for o in outs]) for i in range(len(outs[0]))]


def phase_symbol_serve(dev):
    """Path (a): BERT-base (bf16, seeded) through
    ``checkpoint.save_for_serving`` at input shapes (8, 512) and
    ``serve.load`` into a ``SymbolBlock``, served by a ``ModelServer`` with
    one bucket of 8: one capture at warmup and none in traffic, 25
    LayerNorm and 12 flash forward launches a forward, its rows equal to
    the Gluon model's server's on the same padded batches; a load with one
    weight perturbed (planted) gives rows the comparison catches."""
    import torch
    from mxnet_tpu_torch import amp, checkpoint, serve
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    t_phase = time.perf_counter()
    B = SYMBOL_SERVE_BATCH
    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    layers = len(model.encoder.cells)
    prefix = _export_dir("bert")
    t0 = time.perf_counter()
    sym_file, params_file = checkpoint.save_for_serving(
        prefix, model, input_names=SYMBOL_INPUTS,
        input_shapes=[(B, SEQ), (B, SEQ), (B,)])
    export_s = time.perf_counter() - t0
    with open(sym_file) as f:
        nodes = json.load(f)["nodes"]
    ops = {}
    for n in nodes:
        ops[n["op"]] = ops.get(n["op"], 0) + 1
    t0 = time.perf_counter()
    blk = serve.load(prefix, input_names=SYMBOL_INPUTS, ctx=dev)
    dtypes = sorted({str(p._tensor().dtype)[6:]
                     for p in blk.collect_params().values()})
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    srv = ModelServer(blk, specs, buckets=(B,), timeout_ms=120000.0,
                      device=dev, name="symbol-bert")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    warm = srv.stats()
    ref_srv = ModelServer(model, specs, buckets=(B,), timeout_ms=120000.0,
                          device=dev, name="gluon-bert")
    tok, tt, vl = _bert_requests()
    reset_counters()
    t0 = time.perf_counter()
    got = _export_served_rows(srv, tok, tt, vl)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    stats = srv.stats()
    forwards = len(tok) // B
    t0 = time.perf_counter()
    ref = _export_served_rows(ref_srv, tok, tt, vl)
    ref_wall = (time.perf_counter() - t0) * 1e3
    equal = all(np.array_equal(a, b) for a, b in zip(got, ref))
    worst = max(float(np.abs(a.astype(np.float32) - b.astype(np.float32))
                      .max()) for a, b in zip(got, ref))
    # planted: the export loaded again with one weight perturbed
    bad = serve.load(prefix, input_names=SYMBOL_INPUTS, ctx=dev)
    last = "layer%d_bertpositionwiseffn0_ffn_2_bias" % (layers - 1)
    p = bad.collect_params()[[n for n in bad.collect_params().keys()
                              if n.endswith(last)][0]]
    p.copy_data(p._tensor().detach() + 0.01)
    bad_srv = ModelServer(bad, specs, buckets=(B,), timeout_ms=120000.0,
                          device=dev, name="symbol-bert-planted")
    planted = _export_served_rows(bad_srv, tok[:B], tt[:B], vl[:B])
    planted_equal = all(np.array_equal(a, b[:B]) for a, b in zip(planted,
                                                                 ref))
    for s in (srv, ref_srv, bad_srv):
        s.stop()
    del srv, ref_srv, bad_srv, blk, bad, model
    _drop_export(prefix)
    torch.cuda.empty_cache()
    out = {"card": card_line(), "graph_ops": ops, "param_dtypes": dtypes,
           "export_s": export_s, "load_and_warmup_s": load_s,
           "warm": {k: warm[k] for k in ("captures", "replays", "drops")},
           "stats": {k: stats[k] for k in ("captures", "replays", "drops")},
           "launches": launches, "forwards": forwards,
           "rows_equal_gluon_server": equal, "max_abs_vs_gluon": worst,
           "served_wall_ms": wall, "gluon_served_wall_ms": ref_wall,
           "planted_rows_equal": planted_equal,
           "phase_seconds": time.perf_counter() - t_phase}
    print("symbol serve: BERT-base exported at (%d, %d) (%.1f s; graph %s), "
          "loaded as a SymbolBlock (parameters %s) and warmed in %.1f s: "
          "server %s after warmup, %s after %d forwards; launches %s; rows "
          "equal to the Gluon server's %s (max |diff| %.3g); %d requests in "
          "%.1f ms (Gluon server %.1f ms); one weight perturbed, rows equal "
          "%s; %.1f s, %s" % (
              B, SEQ, export_s, ops, dtypes, load_s, out["warm"],
              out["stats"], forwards, launches, equal, worst, len(tok), wall,
              ref_wall, planted_equal, out["phase_seconds"], out["card"]),
          flush=True)
    check(ops.get("LayerNorm") == 2 * layers + 1 and
          ops.get("scaled_dot_attention") == layers,
          "symbol serve: the exported graph's ops %s" % ops)
    check("bfloat16" in dtypes, "symbol serve: the export reloaded as %s"
          % dtypes)
    check(warm["captures"] == 1 and stats["captures"] == 1 and
          stats["drops"] == 0 and stats["replays"] == warm["replays"]
          + forwards, "symbol serve: captures %s then %s" % (warm, stats))
    check(launches["layernorm"] == (2 * layers + 1) * forwards and
          launches["flash_attention_fwd"] == layers * forwards and
          sum(launches.values()) == (3 * layers + 1) * forwards,
          "symbol serve: launches %s in %d forwards" % (launches, forwards))
    check(equal, "symbol serve: rows differ from the Gluon model's server "
          "(max %.3g)" % worst)
    check(not planted_equal, "symbol serve: a perturbed weight left the "
          "rows equal")
    return out


def xent_dx_last_cols_dropped(x, labels, lse, dy):
    """A planted fault: the plain softmax-xent backward with the last 8
    columns of every row left at 0."""
    from mxnet_tpu_torch.ops.cuda import softmax_xent as sx

    dx = sx.softmax_xent_bwd_plain(x, labels, lse, dy)
    dx[:, -8:] = 0
    return dx


def _symbol_loss(sym_file):
    from mxnet_tpu_torch import sym, symbol

    logits = symbol.load(sym_file)
    label = sym.var("label")
    return sym.mean(sym.softmax_xent_rows(logits, label))


def _symbol_step(ex, inp, tgt):
    """One executor step: forward with training, backward; returns the
    loss and the launches."""
    from mxnet_tpu_torch import nd

    reset_counters()
    loss = ex.forward(is_train=True, data=nd.NDArray(inp),
                      label=nd.NDArray(tgt))[0]
    ex.backward()
    loss = loss._data.detach().clone()
    return loss, read_counters()


def phase_symbol_train(dev):
    """Path (b): GPT-2 small (GPT_TRAIN's recipe, bf16, dropout 0.1)
    exported at (8, 1024), a loss ``mean(softmax_xent_rows(logits,
    label))`` built in ``sym``, ``simple_bind(grad_req='write')``, the
    model's parameters copied in, and three steps of ``forward(is_train=
    True)``, ``backward()`` and an SGD update on the captured executor:
    25 + 25 LayerNorm, 12 + 12 flash and 1 + 1 softmax-xent launches a
    step, one forward and one backward capture and no recapture; the first
    loss against the same loss through the Gluon model eagerly (same
    generator seed) and the first step's gradients within GPT-2's limits of
    its; the xent dx without its last 8 columns (planted, the plain
    versions) read beyond the worst-row limit."""
    import torch
    from mxnet_tpu_torch import autograd, checkpoint
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.ops import F
    from mxnet_tpu_torch.util import load_npz_exact

    t_phase = time.perf_counter()
    step = GPTTrainStep(dev)
    model, params = step.model, step.params
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    prefix = _export_dir("gpt2")
    t0 = time.perf_counter()
    sym_file, params_file = checkpoint.save_for_serving(
        prefix, model, input_shapes=[(B, T)])
    export_s = time.perf_counter() - t0
    # the Gluon model's loss and gradients, eagerly
    mx_random.seed(SEED)
    for p in params:
        p.zero_grad()
    with autograd.record():
        ref_loss = F.mean(F.softmax_xent_rows(model(step.inp), step.tgt))
    autograd.backward(ref_loss)
    ref_grads = _grads_of(params)
    ref_loss = ref_loss.detach()
    loss_sym = _symbol_loss(sym_file)
    weights = load_npz_exact(params_file)
    t0 = time.perf_counter()
    ex = loss_sym.simple_bind(ctx=dev, grad_req="write", data=(B, T),
                              label=(B, T))
    ex.copy_params_from({n: w.to(dev) for n, w in weights.items()
                         if n in ex.arg_dict})
    bind_s = time.perf_counter() - t0
    mx_random.seed(SEED)
    t0 = time.perf_counter()
    rows = []
    for i in range(GPT_TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, launches = _symbol_step(ex, step.inp, step.tgt)
        torch.cuda.synchronize()
        rows.append({"loss": loss, "launches": launches,
                     "wall_ms": (time.perf_counter() - t1) * 1e3})
        if i == 0:
            grads = [ex.grad_dict[p.name]._data.detach().clone()
                     for p in params]
        with torch.no_grad():  # SGD on the executor's arguments
            for p in params:
                w = ex.arg_dict[p.name]._data
                w.sub_((1e-3 * ex.grad_dict[p.name]._data).to(w.dtype))
    steps_s = time.perf_counter() - t0
    stats = dict(ex.stats)
    grad_reading = _grad_reading(step, grads, ref_grads)
    loss_err = float((rows[0]["loss"] - ref_loss).abs())
    first_bitwise = bool(torch.equal(rows[0]["loss"], ref_loss))
    del grads, ex
    torch.cuda.empty_cache()
    # planted: a fresh executor on the plain versions, the xent dx without
    # its last 8 columns
    ex2 = loss_sym.simple_bind(ctx=dev, grad_req="write", data=(B, T),
                               label=(B, T))
    ex2.copy_params_from({n: w.to(dev) for n, w in weights.items()
                          if n in ex2.arg_dict})
    mx_random.seed(SEED)
    with plain_versions(softmax_xent_bwd=xent_dx_last_cols_dropped):
        _symbol_step(ex2, step.inp, step.tgt)
    planted = _grad_reading(step, [ex2.grad_dict[p.name]._data
                                   for p in params], ref_grads)
    del ex2, ref_grads, step, model, weights
    _drop_export(prefix)
    torch.cuda.empty_cache()
    out = {"card": card_line(), "export_s": export_s, "bind_s": bind_s,
           "losses": [float(r["loss"]) for r in rows],
           "gluon_loss": float(ref_loss), "first_loss_abs_err": loss_err,
           "first_loss_bitwise": first_bitwise, "grads": grad_reading,
           "launches": [r["launches"] for r in rows],
           "step_wall_ms": [r["wall_ms"] for r in rows],
           "steps_s": steps_s, "stats": stats,
           "planted_xent_dx_last_8_cols": planted,
           "phase_seconds": time.perf_counter() - t_phase}
    print("symbol train: GPT-2 small exported at (%d, %d) (%.1f s), bound "
          "with the loss in %.1f s; losses %s (the Gluon model's first %.6f, "
          "|diff| %.3g, bit for bit %s); first step's gradients vs the "
          "Gluon model's: worst %.3g, worst row %.3g (limits %g, %g); "
          "executor %s; step walls %s ms (the first with the captures); "
          "launches a step %s; planted xent dx without its last 8 columns: "
          "worst %.3g, worst row %.3g; %.1f s, %s" % (
              B, T, export_s, bind_s, ["%.5f" % x for x in out["losses"]],
              out["gluon_loss"], loss_err, first_bitwise,
              grad_reading["worst_grad_rel_l2"],
              grad_reading["worst_row_rel_l2"], GPT_STEP_GRAD_TOL,
              GPT_STEP_ROW_TOL, stats, ["%.1f" % w for w in
                                        out["step_wall_ms"]],
              out["launches"][0], planted["worst_grad_rel_l2"],
              planted["worst_row_rel_l2"], out["phase_seconds"],
              out["card"]), flush=True)
    L = GPT_CONFIG["num_layers"]
    want = {"layernorm": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd": L,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
            "flash_attention_fwd_f32": 0}
    for i, got in enumerate(out["launches"]):
        check(got == want, "symbol train step %d: launches %s" % (i, got))
    check(all(np.isfinite(out["losses"])), "symbol train: a loss is not "
          "finite")
    check(loss_err <= STEP_LOSS_TOL, "symbol train: the first loss %.6f "
          "against the Gluon model's %.6f" % (out["losses"][0],
                                              out["gluon_loss"]))
    check(grad_reading["within"], "symbol train: the first step's gradients "
          "outside GPT-2's limits: %s" % grad_reading)
    check(stats == {"forward_captures": 1, "backward_captures": 1,
                    "forward_replays": GPT_TRAIN_STEPS,
                    "backward_replays": GPT_TRAIN_STEPS, "recaptures": 0},
          "symbol train: executor %s" % stats)
    check(planted["worst_row_rel_l2"] > GPT_STEP_ROW_TOL,
          "symbol train: the planted xent fault read within the limits: %s"
          % planted)
    return out


# ------------------------------------------ A.14 closed, A.15's host I/O
# path (a): GPT-2 small (GPT_TRAIN's recipe) through Module.fit, Adam
# lr 1e-4 with fp32 masters, three batches of MODULE_FIT_BATCHES
MODULE_FIT_BATCHES = 3
MODULE_OPT = {"learning_rate": 1e-4, "multi_precision": True}
# path (b): the bench.py bert step fed by the Gluon data path
PIPELINE_SAMPLES = 256
PIPELINE_WORKERS = 2
# path (c): LSTM PTB through the legacy API: sentence lengths a bucket
LSTM_BUCKETS = (10, 20, 35)
BUCKET_LENGTHS = {10: (5, 10), 20: (11, 20), 35: (21, 35)}
BUCKET_EPOCHS = 2
# control flow at the LSTM's width, fp32 with TF32 off: the foreach LSTM
# against the fused RNN op, a captured graph against the same graph eagerly
CF_LSTM_TOL = 1e-4
CF_EAGER_TOL = 1e-6


def _module_loss(sym_file):
    """``MakeLoss(mean(softmax_xent_rows(logits, label)))`` over an
    export's logits (``phase_symbol_train``'s loss as a Module head)."""
    from mxnet_tpu_torch import sym, symbol

    logits = symbol.load(sym_file)
    return sym.MakeLoss(sym.mean(sym.softmax_xent_rows(logits,
                                                       sym.var("label"))))


def _programs_read_current_weights(mod):
    """How many of the module's parameters the program of its last
    training forward read at values other than the parameters' current
    ones (a stale weight)."""
    import torch
    from mxnet_tpu_torch.symbol import _Program

    ex = mod._exec
    state = ex._last[0]
    read = state.static if isinstance(state, _Program) else state[0]
    return sum(not torch.equal(t.detach(), mod._arg_params[n]._data)
               for n, t in zip(ex._names, read) if n in mod._arg_params)


def _stale_update(mod):
    """A planted fault: ``Module.update`` stepping copies of the weights
    (new arrays the executor does not hold), the stale-weight trap."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.module import Module

    def update():
        for n in list(mod._arg_params):
            mod._arg_params[n] = nd.NDArray(mod._arg_params[n]._data.clone())
        Module.update(mod)

    return update


def phase_module_fit(dev):
    """Path (a): GPT-2 small exported at (8, 1024), the loss
    ``MakeLoss(mean(softmax_xent_rows))`` as a ``Module`` fed by
    ``io.PrefetchingIter(io.NDArrayIter(...))`` over three seeded batches,
    ``fit(optimizer="adam")``; then ``score`` (``metric.Loss``),
    ``predict``, ``save_checkpoint``/``Module.load`` and a forward. Held to
    the Gluon model's two eager steps from the same generator seed (loss
    1e-2, first gradients GPT-2's limits), the first update to a
    ``gluon.Trainer``'s Adam on the module's own gradients (1e-4), every
    weight a training program read to the module's current one (a planted
    update into copies must show), 25/25 LayerNorm, 12/12 flash and 1/1
    softmax-xent a step, one forward and one backward capture; the loaded
    module's eval forward bit for bit the saving module's."""
    import torch
    from mxnet_tpu_torch import autograd, checkpoint, gluon, io, metric, nd
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.context import context_from_device
    from mxnet_tpu_torch.module import Module
    from mxnet_tpu_torch.ops import F
    from mxnet_tpu_torch.util import load_npz_exact

    t_phase = time.perf_counter()
    step = GPTTrainStep(dev, "adam", dict(MODULE_OPT))
    model, params = step.model, step.params
    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    ctx = context_from_device(dev)
    prefix = _export_dir("gpt2_module")
    sym_file, params_file = checkpoint.save_for_serving(
        prefix, model, input_shapes=[(B, T)])
    weights = load_npz_exact(params_file)
    seq = np.random.default_rng(SEED + 19).integers(
        0, GPT_CONFIG["vocab_size"],
        (MODULE_FIT_BATCHES * B, T + 1)).astype(np.int32)
    X, Y = np.ascontiguousarray(seq[:, :-1]), np.ascontiguousarray(seq[:, 1:])

    def batch_tensors(i):
        return [torch.from_numpy(a[i * B:(i + 1) * B]).to(dev)
                for a in (X, Y)]

    # the Gluon model: two eager steps from the seed, the Trainer between
    mx_random.seed(SEED)
    ref_losses = []
    for i in range(2):
        xb, yb = batch_tensors(i)
        for p in params:
            p.zero_grad()
        with autograd.record():
            loss = F.mean(F.softmax_xent_rows(model(xb), yb))
        autograd.backward(loss)
        ref_losses.append(float(loss))
        if i == 0:
            ref_grads = _grads_of(params)
            step.trainer.step(1)

    class StepLosses(metric.Loss):
        def __init__(self):
            super().__init__()
            self.steps = []

        def update(self, labels, preds):
            self.steps.append(float(preds[0].asnumpy()))
            super().update(labels, preds)

    mod = Module(_module_loss(sym_file), data_names=("data",),
                 label_names=("label",), context=ctx)
    with ctx:
        train_iter = io.PrefetchingIter(io.NDArrayIter(
            X, Y, batch_size=B, label_name="label"))
    mod.bind([("data", (B, T))], [("label", (B, T))])
    mod.init_params(arg_params={n: nd.NDArray(w.to(dev))
                                for n, w in weights.items()})
    rows, first = [], {}
    plain_fb, plain_update = mod.forward_backward, mod.update

    def forward_backward(batch):
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        plain_fb(batch)
        torch.cuda.synchronize()
        rows.append({"launches": read_counters(),
                     "wall_ms": (time.perf_counter() - t0) * 1e3,
                     "stale_weights": _programs_read_current_weights(mod)})

    def update():
        if not first:
            first["p0"] = {n: a._data.detach().clone()
                           for n, a in mod._arg_params.items()}
            first["grads"] = {n: g._data.detach().clone()
                              for n, g in mod._exec.grad_dict.items()}
        plain_update()
        first.setdefault("p1", {n: a._data.detach().clone()
                                for n, a in mod._arg_params.items()})

    mod.forward_backward, mod.update = forward_backward, update
    losses = StepLosses()
    mx_random.seed(SEED)
    t0 = time.perf_counter()
    fit_result = mod.fit(train_iter, eval_metric=losses, optimizer="adam",
                         optimizer_params=dict(MODULE_OPT))
    fit_s = time.perf_counter() - t0
    stats = dict(mod._exec.stats)
    grads = [first["grads"][p.name] for p in params]
    grad_reading = _grad_reading(step, grads, ref_grads)
    # the first update against a gluon.Trainer's on the same gradients
    tr = gluon.Trainer(model.collect_params(), "adam", dict(MODULE_OPT))
    with torch.no_grad():
        for p in params:
            p._tensor().copy_(first["p0"][p.name])
            p._tensor().grad = first["grads"][p.name].clone()
    tr.step(1)
    update_err = max(max_err(p._tensor(), first["p1"][p.name])
                     for p in params)
    del first, grads, ref_grads
    # score and predict (eval forwards), then the checkpoint round trip
    with ctx:
        eval_iter = io.NDArrayIter(X, Y, batch_size=B, label_name="label")
        (score_name, score), = mod.score(eval_iter, metric.Loss())
        preds = mod.predict(eval_iter, merge_batches=False)
    pred_mean = float(np.mean([float(o[0].asnumpy()) for o in preds]))
    ck = _export_dir("gpt2_module_ck")
    mod.save_checkpoint(ck, MODULE_FIT_BATCHES)
    mod2 = Module.load(ck, MODULE_FIT_BATCHES, data_names=("data",),
                       label_names=("label",), context=ctx)
    mod2.bind([("data", (B, T))], [("label", (B, T))])
    mod2.init_params()
    loaded_dtypes = sorted({str(a._data.dtype)
                            for a in mod2._arg_params.values()})
    dtypes_kept = all(a._data.dtype == mod._arg_params[n]._data.dtype
                      for n, a in mod2._arg_params.items())
    xb, yb = batch_tensors(0)
    b0 = io.DataBatch([nd.NDArray(xb)], [nd.NDArray(yb)])
    saved_out = mod.forward(b0, is_train=False)[0]._data.clone()
    loaded_out = mod2.forward(b0, is_train=False)[0]._data.clone()
    loaded_bitwise = bool(torch.equal(saved_out, loaded_out))
    del mod2
    for suffix in ("-symbol.json", "-%04d.params" % MODULE_FIT_BATCHES):
        if os.path.exists(ck + suffix):
            os.remove(ck + suffix)
    # planted: Module.update into copies of the weights
    mod.update = _stale_update(mod)
    planted_stale = []
    with ctx:
        for batch in io.NDArrayIter(X[:2 * B], Y[:2 * B], batch_size=B,
                                    label_name="label"):
            mod.forward(batch, is_train=True)
            planted_stale.append(_programs_read_current_weights(mod))
            mod.backward()
            mod.update()
    del mod, step, model
    torch.cuda.empty_cache()
    routes = _predict_routes(dev, ctx, sym_file, weights, X)
    _drop_export(prefix)
    torch.cuda.empty_cache()
    out = {"card": card_line(), "losses": losses.steps,
           "fit_result": list(fit_result), "fit_s": fit_s,
           "gluon_losses": ref_losses,
           "first_loss_abs_err": abs(losses.steps[0] - ref_losses[0]),
           "first_loss_bitwise": losses.steps[0] == ref_losses[0],
           "second_loss_abs_err": abs(losses.steps[1] - ref_losses[1]),
           "grads": grad_reading, "first_update_max_err": update_err,
           "launches": [r["launches"] for r in rows],
           "step_wall_ms": [r["wall_ms"] for r in rows],
           "stale_weights": [r["stale_weights"] for r in rows],
           "planted_stale_weights": planted_stale, "stats": stats,
           "score": [score_name, score], "predict_mean": pred_mean,
           "loaded_dtypes": loaded_dtypes, "loaded_dtypes_kept": dtypes_kept,
           "loaded_bitwise": loaded_bitwise, "predict_routes": routes,
           "phase_seconds": time.perf_counter() - t_phase}
    print("module fit: GPT-2 small, 3 steps of Module.fit over a "
          "PrefetchingIter: losses %s (Gluon %s; first |diff| %.3g, bit for "
          "bit %s; second |diff| %.3g); first gradients vs Gluon: worst %.3g,"
          " row %.3g; first update vs gluon.Trainer %.3g; stale weights read "
          "%s, planted %s; executor %s; launches a step %s; score %s = %.6f, "
          "predict mean %.6f; checkpoint reload %s bit for bit %s; step walls"
          " %s ms; logits predict by route %s; %.1f s, %s" % (
              ["%.6f" % v for v in losses.steps],
              ["%.6f" % v for v in ref_losses], out["first_loss_abs_err"],
              out["first_loss_bitwise"], out["second_loss_abs_err"],
              grad_reading["worst_grad_rel_l2"],
              grad_reading["worst_row_rel_l2"], update_err,
              out["stale_weights"], planted_stale, stats, out["launches"][0],
              score_name, score, pred_mean, loaded_dtypes, loaded_bitwise,
              ["%.1f" % w for w in out["step_wall_ms"]], routes,
              out["phase_seconds"], out["card"]), flush=True)
    L = GPT_CONFIG["num_layers"]
    want = {"layernorm": 2 * L + 1, "layernorm_bwd": 2 * L + 1,
            "flash_attention_fwd": L, "flash_attention_bwd": L,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 1,
            "flash_attention_fwd_f32": 0}
    check(len(rows) == MODULE_FIT_BATCHES,
          "module fit: %d steps, not %d" % (len(rows), MODULE_FIT_BATCHES))
    for i, got in enumerate(out["launches"]):
        check(got == want, "module fit step %d: launches %s" % (i, got))
    check(all(np.isfinite(losses.steps)), "module fit: a loss not finite")
    check(out["first_loss_abs_err"] <= STEP_LOSS_TOL,
          "module fit: first loss %.6f, the Gluon model's %.6f"
          % (losses.steps[0], ref_losses[0]))
    check(out["second_loss_abs_err"] <= STEP_LOSS_TOL,
          "module fit: second loss %.6f, the Gluon Trainer's %.6f"
          % (losses.steps[1], ref_losses[1]))
    check(grad_reading["within"], "module fit: the first gradients outside "
          "GPT-2's limits: %s" % grad_reading)
    check(update_err <= 1e-4, "module fit: the first update %.3g from "
          "gluon.Trainer's on the same gradients" % update_err)
    check(stats == {"forward_captures": 1, "backward_captures": 1,
                    "forward_replays": MODULE_FIT_BATCHES,
                    "backward_replays": MODULE_FIT_BATCHES,
                    "recaptures": 0}, "module fit: executor %s" % stats)
    check(all(s == 0 for s in out["stale_weights"]),
          "module fit: a program read a stale weight: %s"
          % out["stale_weights"])
    check(planted_stale[-1] > 0, "module fit: the planted update into "
          "copies of the weights went unseen: %s" % planted_stale)
    check(score_name == "loss" and abs(score - pred_mean) <= 1e-6 * abs(
        score), "module fit: score %.7f against predict's %.7f"
          % (score, pred_mean))
    check(dtypes_kept and "torch.bfloat16" in loaded_dtypes
          and loaded_bitwise, "module fit: the loaded module's eval forward "
          "(dtypes %s, kept %s) is not the saving module's bit for bit"
          % (loaded_dtypes, dtypes_kept))
    check(routes["stats"] == {"pool": MODULE_FIT_BATCHES,
                              "per_batch": MODULE_FIT_BATCHES}
          and routes["dtypes"] == ["torch.bfloat16"] * 2
          and routes["devices"] == [torch.device(dev).type] * 2
          and routes["rel_err"] <= 1e-2,
          "module fit: predict's pool and per-batch routes apart: %s"
          % routes)
    return out


def _predict_routes(dev, ctx, sym_file, weights, X):
    """GPT-2 small's logits (8 x 1024 x 50257, bf16) through
    ``Module.predict`` both ways over the fit's three batches: the pool (a
    hybridized ``SymbolBlock`` under ``BucketedExecutor``, its inputs and
    outputs on the card) and the per-batch forward (the ``Executor``'s
    captured eval program). Each route's second, warm call timed; the
    rows of one against the other's."""
    import torch
    from mxnet_tpu_torch import io, nd, symbol
    from mxnet_tpu_torch.module import Module

    B, T = GPT_TRAIN["batch"], GPT_TRAIN["seq"]
    pm = Module(symbol.load(sym_file), data_names=("data",), label_names=(),
                context=ctx)
    pm.bind([("data", (B, T))], for_training=False)
    pm.init_params(arg_params={n: nd.NDArray(w.to(dev))
                               for n, w in weights.items()})
    with ctx:
        it = io.NDArrayIter(X, batch_size=B)
    got, ms = {}, {}
    for route in ("pool", "per_batch"):
        pm._pred_pool = None if route == "pool" else (None, None)
        for _ in range(2):
            pm.predict_stats = {"pool": 0, "per_batch": 0}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx:
                outs = pm.predict(it, merge_batches=False)
            torch.cuda.synchronize()
        ms[route] = (time.perf_counter() - t0) * 1e3
        got[route] = ([o[0]._data for o in outs],
                      pm.predict_stats[route])
    pool, per = got["pool"][0], got["per_batch"][0]
    err = max(max_err(a, b) for a, b in zip(pool, per))
    mag = max(float(b.float().abs().max()) for b in per)
    out = {"pool_ms": ms["pool"], "per_batch_ms": ms["per_batch"],
           "max_abs_err": err, "rel_err": err / mag,
           "dtypes": [str(pool[0].dtype), str(per[0].dtype)],
           "devices": [pool[0].device.type, per[0].device.type],
           "stats": {k: v[1] for k, v in got.items()}}
    del pm, got, pool, per, outs
    torch.cuda.empty_cache()
    return out


def _pipeline_step(step, parts, seed):
    """One step of the bert recipe on a batch as NDArrays (the idiom):
    record, backward; the per-sample loss and the launches."""
    from mxnet_tpu_torch import autograd
    from mxnet_tpu_torch import random as mx_random

    tok, tt, vl, mp, mlm_y, nsp_y = parts
    mx_random.seed(seed)
    reset_counters()
    with autograd.record():
        _, _, nsp, mlm = step.model(tok, tt, vl, mp)
        loss = step.mlm_loss(mlm, mlm_y) + step.nsp_loss(nsp, nsp_y)
    loss.backward()
    return loss, read_counters()


def _rebinding_clip(arrays, max_norm):
    """A planted fault: ``clip_global_norm`` as the JAX package writes it,
    each array rebound to a scaled copy (a Parameter's gradient, which the
    Trainer reads, stays unscaled)."""
    import math

    total = 0.0
    for a in arrays:
        total += float((a._data.float() ** 2).sum())
    norm = math.sqrt(total)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for a in arrays:
            a._data = a._data * scale
    return norm


def phase_data_pipeline(dev):
    """Path (b): the ``bench.py`` ``bert`` step (BERT128, ``TrainStep``'s
    model, amp and Adam) fed by ``DataLoader(ArrayDataset(256 seeded
    samples), batch 64, a seeded RandomSampler, last_batch="discard",
    num_workers=2, pin_memory=True)``, ``split_and_load(batch, [gpu(0)])``,
    ``record``/``backward``, ``clip_global_norm`` at half the first step's
    norm and ``trainer.step(64)``. Each consumed batch equals the same
    loader's on the CPU byte for byte; the first loss equals ``TrainStep``
    fed the same batch directly bit for bit; the norm is within 1e-6 of an
    fp64 norm; the update equals one from gradients scaled by hand (bit for
    bit), which a planted rebinding clip must miss; 26/26 LayerNorm and
    2/2 softmax-xent a step, no flash; the process-worker loader gives the
    same batches and its workers saw no CUDA device."""
    import torch
    from mxnet_tpu_torch import cpu, gluon
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.context import context_from_device
    from mxnet_tpu_torch.gluon import data as gdata
    from mxnet_tpu_torch.gluon import utils as gutils

    t_phase = time.perf_counter()
    step = TrainStep(dev, BERT128)
    params = step.params
    B = BERT128["batch"]
    arrays = make_batch(np.random.default_rng(SEED + 31), PIPELINE_SAMPLES,
                        BERT128["seq"], BERT128["masked"])
    ds = gdata.ArrayDataset(*arrays)

    def loader(**kw):
        return gdata.DataLoader(
            ds, batch_size=B, last_batch="discard",
            sampler=gdata.RandomSampler(PIPELINE_SAMPLES, seed=SEED), **kw)

    with cpu():
        want = [[a.asnumpy() for a in b] for b in loader()]
    ctx = context_from_device(dev)
    consumed, rows = [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(loader(num_workers=PIPELINE_WORKERS,
                                     pin_memory=True)):
        parts = [gutils.split_and_load(b, [ctx])[0] for b in batch]
        consumed.append([p.asnumpy() for p in parts])
        if i == 0:  # TrainStep fed the same batch directly
            step.batch = [p._data for p in parts]
            mx_random.seed(SEED + 40)
            direct = step(update=False)
        loss, launches = _pipeline_step(step, parts, SEED + 40 + i)
        grads = [p.grad() for p in params]
        row = {"loss": float(loss.mean().asscalar()), "launches": launches}
        if i == 0:
            row["loss_bitwise_direct"] = bool(torch.equal(loss._data,
                                                          direct))
            g0 = [g._data.detach().clone() for g in grads]
            p0 = [p._tensor().detach().clone() for p in params]
            norm0 = gutils.clip_global_norm(grads, float("inf"))
            max_norm = norm0 / 2
            fp64 = float(np.sqrt(sum(float((g.double() ** 2).sum())
                                     for g in g0)))
            row["norm"], row["norm_fp64"] = norm0, fp64
        norm = gutils.clip_global_norm(grads, max_norm)
        step.trainer.step(B)
        row["clip_norm"] = norm
        if i == 0:
            pa = [p._tensor().detach().clone() for p in params]
            scale = max_norm / (norm0 + 1e-8)
            readings = {}
            for label, clip in (("by_hand", None),
                                ("planted_rebinding_clip", _rebinding_clip)):
                tr = gluon.Trainer(step.model.collect_params(), "adam", {
                    "learning_rate": 1e-4, "wd": 0.01,
                    "multi_precision": True})
                with torch.no_grad():
                    for p, w, g in zip(params, p0, g0):
                        p._tensor().copy_(w)
                        p._tensor().grad = g * scale if clip is None \
                            else g.clone()
                if clip is not None:
                    clip([p.grad() for p in params], max_norm)
                tr.step(B)
                readings[label] = sum(not torch.equal(p._tensor(), a)
                                      for p, a in zip(params, pa))
            with torch.no_grad():
                for p, a in zip(params, pa):
                    p._tensor().copy_(a)
            row["params_apart"] = readings
            del g0, p0, pa
        rows.append(row)
    pipeline_s = time.perf_counter() - t0
    same = len(consumed) == len(want) and all(
        all(np.array_equal(a, b) for a, b in zip(c, w))
        for c, w in zip(consumed, want))
    procs = loader(num_workers=PIPELINE_WORKERS, thread_pool=False)
    t0 = time.perf_counter()
    with ctx:
        proc_batches = [[a.asnumpy() for a in b] for b in procs]
    proc_s = time.perf_counter() - t0
    reports = procs.worker_reports + procs.worker_probe()
    procs.close()
    proc_same = len(proc_batches) == len(want) and all(
        all(np.array_equal(a, b) for a, b in zip(c, w))
        for c, w in zip(proc_batches, want))
    del step
    torch.cuda.empty_cache()
    out = {"card": card_line(), "steps": rows, "batches_equal_cpu": same,
           "pipeline_s": pipeline_s, "process_batches_equal_cpu": proc_same,
           "process_loader_s": proc_s, "worker_reports": reports,
           "phase_seconds": time.perf_counter() - t_phase}
    r0 = rows[0]
    print("data pipeline: bert128 fed by DataLoader(pin_memory, %d threads):"
          " %d batches equal the CPU loader's %s; losses %s, the first bit "
          "for bit TrainStep's %s; norm %.9g against fp64 %.9g, clipped to "
          "%.6g; parameters apart from the hand-scaled update %s; launches a "
          "step %s; process workers: batches equal %s, reports %s; %.1f s, "
          "%s" % (PIPELINE_WORKERS, len(rows), same,
                  ["%.5f" % r["loss"] for r in rows],
                  r0["loss_bitwise_direct"], r0["norm"], r0["norm_fp64"],
                  max_norm, r0["params_apart"], r0["launches"], proc_same,
                  reports, out["phase_seconds"], out["card"]), flush=True)
    want_l = dict(STEP_LAUNCHES, flash_attention_fwd=0, flash_attention_bwd=0,
                  flash_attention_fwd_f32=0)
    check(len(rows) == PIPELINE_SAMPLES // B, "data pipeline: %d steps"
          % len(rows))
    for i, r in enumerate(rows):
        check(all(r["launches"][k] == n for k, n in want_l.items()),
              "data pipeline step %d: launches %s" % (i, r["launches"]))
        check(np.isfinite(r["loss"]), "data pipeline: loss not finite")
    check(same, "data pipeline: a consumed batch differs from the CPU "
          "loader's")
    check(r0["loss_bitwise_direct"], "data pipeline: the first loss is not "
          "TrainStep's on the same batch bit for bit")
    check(abs(r0["norm"] - r0["norm_fp64"]) <= 1e-6 * r0["norm_fp64"],
          "data pipeline: norm %.9g against fp64 %.9g" % (r0["norm"],
                                                          r0["norm_fp64"]))
    check(r0["params_apart"]["by_hand"] == 0, "data pipeline: the clipped "
          "update differs from the hand-scaled one in %d parameters"
          % r0["params_apart"]["by_hand"])
    check(r0["params_apart"]["planted_rebinding_clip"] > 0,
          "data pipeline: the planted rebinding clip went unseen")
    check(proc_same, "data pipeline: the process-worker loader's batches "
          "differ")
    check(all(r["CUDA_VISIBLE_DEVICES"] == "" and not r["cuda_initialized"]
              and r["device_count"] == 0 for r in reports),
          "data pipeline: a worker process saw the card: %s" % reports)
    return out


def _bucket_sentences():
    rng = np.random.default_rng(SEED + 37)
    out = []
    for b in LSTM_BUCKETS:
        lo, hi = BUCKET_LENGTHS[b]
        for _ in range(LSTM_RECIPE["batch"]):
            out.append(list(rng.integers(1, LSTM_RECIPE["vocab"],
                                         int(rng.integers(lo, hi + 1)))))
    return out


def _sym_lstm_cell(S, x, h, c, layer, H):
    """One LSTM step (gates i, f, g, o, as the fused op) in Symbols over
    the layer's variables ``l<layer>_{i2h,h2h}_{weight,bias}``."""
    def fc(inp, kind):
        return S.FullyConnected(inp, S.var("l%d_%s_weight" % (layer, kind)),
                                S.var("l%d_%s_bias" % (layer, kind)),
                                num_hidden=4 * H)

    gates = fc(x, "i2h") + fc(h, "h2h")

    def gate(k):
        return S.slice_axis(gates, axis=1, begin=k * H, end=(k + 1) * H)

    c2 = S.sigmoid(gate(1)) * c + S.sigmoid(gate(0)) * S.tanh(gate(2))
    return S.sigmoid(gate(3)) * S.tanh(c2), c2


def phase_control_flow(dev, tokens):
    """Control flow at the LSTM's width (650, batch 32, 35 steps), fp32
    with TF32 off: a 2-layer LSTMCell unrolled by ``sym.contrib.foreach``
    over the bucket-35 batch's embeddings, bound and captured, against the
    fused ``RNN`` op on the same weights; a ``while_loop`` graph and a
    ``cond`` graph through the captured Executor against the same graphs
    eagerly; the cond's gradient where its unselected branch (log at 0 and
    below) has an infinite derivative; a predicate computed once a run in
    the program (``_cond_predicate_runs``)."""
    import torch
    from mxnet_tpu_torch import gluon, nd, sym

    H, N = 650, LSTM_RECIPE["batch"]
    T = tokens.shape[0]
    g = torch.Generator(device=dev).manual_seed(SEED + 43)
    lstm = gluon.rnn.LSTM(H, num_layers=2, input_size=H)
    lstm.initialize(device=dev, generator=g)
    emb = torch.randn(LSTM_RECIPE["vocab"], H, device=dev, generator=g)
    x = emb[tokens.long()]
    zeros = torch.zeros(2, N, H, device=dev)
    with torch.no_grad():
        ref, (hn, cn) = lstm(x, [zeros, zeros])

    def body(xt, states):
        h0, c0, h1, c1 = states
        h0, c0 = _sym_lstm_cell(sym, xt, h0, c0, 0, H)
        h1, c1 = _sym_lstm_cell(sym, h0, h1, c1, 1, H)
        return h1, [h0, c0, h1, c1]

    names = ["h0", "c0", "h1", "c1"]
    outs, states = sym.contrib.foreach(body, sym.var("x"),
                                       [sym.var(n) for n in names])
    graph = sym.Group([outs] + states)
    args = {"x": nd.NDArray(x)}
    args.update({n: nd.NDArray(torch.zeros(N, H, device=dev))
                 for n in names})
    for p in lstm.collect_params().values():
        args[p.name[len(lstm.prefix):]] = nd.NDArray(p._tensor().detach())
    ex = graph.bind(dev, args)
    got = [o._data for o in ex.forward(is_train=False)]
    foreach_err = max(max_err(got[0], ref), max_err(got[1], hn[0]),
                      max_err(got[2], cn[0]), max_err(got[3], hn[1]),
                      max_err(got[4], cn[1]))
    foreach_captured = ex.stats["forward_captures"] == 1
    # a while_loop and a cond graph: captured against eager
    w = torch.randn(H, H, device=dev, generator=g) / H ** 0.5
    i0 = sym.var("i0")
    xv = sym.var("xv")

    def wl_func(vs):
        i, v = vs
        nv = sym.tanh(sym.FullyConnected(v, sym.var("w"), num_hidden=H,
                                         no_bias=True))
        return nv, [i + 1.0, nv]

    wl_out, (wl_i, wl_x) = sym.contrib.while_loop(
        lambda vs: vs[0] < 20.0, wl_func, [i0, xv], max_iterations=25)
    wl_graph = sym.Group([wl_out, wl_i, wl_x])
    wl_args = {"i0": nd.NDArray(torch.zeros(1, device=dev)),
               "xv": nd.NDArray(x[0]), "w": nd.NDArray(w)}
    wl_ex = wl_graph.bind(dev, wl_args)
    wl_cap = [o._data for o in wl_ex.forward(is_train=False)]
    wl_eager = [o._data for o in wl_graph.eval(**wl_args)]
    wl_err = max(max_err(a, b) for a, b in zip(wl_cap, wl_eager))
    p, xc = sym.var("p"), sym.var("xc")
    cond_graph = sym.contrib.cond(p, lambda: xc * 3.0 + 1.0,
                                  lambda: sym.log(xc))
    xcv = x[0].clone()
    xcv[:, :8] = 0.0
    xcv[:, 8:16] = -1.0
    c_args = {"p": nd.NDArray(torch.ones(1, device=dev)),
              "xc": nd.NDArray(xcv)}
    c_grads = {"xc": nd.NDArray(torch.zeros_like(xcv)),
               "p": nd.NDArray(torch.zeros(1, device=dev))}
    c_ex = cond_graph.bind(dev, c_args, c_grads)
    c_cap = c_ex.forward(is_train=True)[0]._data.clone()
    c_ex.backward()
    c_grad = c_ex.grad_dict["xc"]._data
    c_eager = cond_graph.eval(**c_args)[0]._data
    cond_err = max_err(c_cap, c_eager)
    cond_grad_finite = bool(torch.isfinite(c_grad).all())
    cond_grad_err = float((c_grad - 3.0).abs().max())
    pred_reading = _cond_predicate_runs(dev, x[0], xcv)
    out = {"foreach_lstm_max_err": foreach_err,
           "foreach_captured": foreach_captured,
           "foreach_stats": dict(ex.stats),
           "while_captured_vs_eager": wl_err,
           "while_stats": dict(wl_ex.stats),
           "cond_captured_vs_eager": cond_err,
           "cond_grad_finite": cond_grad_finite,
           "cond_grad_max_err": cond_grad_err,
           "cond_stats": dict(c_ex.stats), "cond_predicates": pred_reading}
    print("control flow at (%d, %d, %d), fp32: foreach LSTM against the "
          "fused RNN op %.3g (captured %s); while_loop captured against "
          "eager %.3g; cond %.3g, its gradient finite %s (|g - 3| %.3g) "
          "with log at 0 and -1 in the unselected branch; predicates "
          "computed in the program %s" % (
              T, N, H, foreach_err, foreach_captured, wl_err, cond_err,
              cond_grad_finite, cond_grad_err, pred_reading), flush=True)
    check(foreach_captured and foreach_err <= CF_LSTM_TOL,
          "control flow: foreach LSTM %.3g from the fused RNN op"
          % foreach_err)
    check(wl_err <= CF_EAGER_TOL, "control flow: the captured while_loop "
          "%.3g from eager" % wl_err)
    check(cond_err <= CF_EAGER_TOL, "control flow: the captured cond %.3g "
          "from eager" % cond_err)
    check(cond_grad_finite and cond_grad_err == 0.0,
          "control flow: the cond's gradient %s (finite %s)"
          % (cond_grad_err, cond_grad_finite))
    r = pred_reading
    check(r["steady_launches"] == {"layernorm": 1}
          and r["flip_launches"] == {"layernorm": 2},
          "control flow: a cond's predicate launched %s in a steady forward "
          "and %s in a flipped one" % (r["steady_launches"],
                                      r["flip_launches"]))
    check(r["steady_reruns"] == 0 and r["flip_reruns"] == 1
          and r["flip_err"] <= CF_EAGER_TOL,
          "control flow: a cond forward ran again %d times steady, %d "
          "flipped; flipped %.3g from eager" % (
              r["steady_reruns"], r["flip_reruns"], r["flip_err"]))
    check(r["dropout_branch_mismatches"] == 0 and 0 < r["dropout_then"]
          < r["dropout_forwards"],
          "control flow: a predicate over a dropout: %d forwards took the "
          "branch their own mask did not pick, then taken %d of %d"
          % (r["dropout_branch_mismatches"], r["dropout_then"],
             r["dropout_forwards"]))
    return out


def _cond_predicate_runs(dev, xrow, xcv):
    """A captured cond whose predicate launches the LayerNorm kernel
    (``mean(LayerNorm(x)) > t``): one launch a steady forward, two and one
    run again where the predicate flips, the flipped output equal to eager.
    Then a predicate over a Dropout the branches share, 16 captured
    training forwards: each takes the branch its own mask picks."""
    import torch
    from mxnet_tpu_torch import engine, nd, sym

    def nonzero(d):
        return {k: v for k, v in d.items() if v}

    xs, g, b, t = sym.var("xs"), sym.var("g"), sym.var("b"), sym.var("t")
    pred = sym.mean(sym.LayerNorm(xs, g, b)) > t
    graph = sym.contrib.cond(pred, lambda: xs * 3.0 + 1.0,
                             lambda: sym.log(xs))
    H = xrow.shape[-1]
    args = {"xs": nd.NDArray(xrow.abs() + 0.5),
            "g": nd.NDArray(torch.ones(H, device=dev)),
            "b": nd.NDArray(torch.zeros(H, device=dev)),
            "t": nd.NDArray(torch.full((1,), -1.0, device=dev))}
    ex = graph.bind(dev, args)
    for _ in range(2):
        ex.forward(is_train=False)
    torch.cuda.synchronize()
    reset_counters()
    reruns = engine.cond_rerun_counter.count
    ex.forward(is_train=False)
    torch.cuda.synchronize()
    out = {"steady_launches": nonzero(read_counters()),
           "steady_reruns": engine.cond_rerun_counter.count - reruns}
    flipped = dict(args, t=nd.NDArray(torch.ones(1, device=dev)))
    reset_counters()
    reruns = engine.cond_rerun_counter.count
    got = ex.forward(is_train=False, t=flipped["t"])[0]._data
    torch.cuda.synchronize()
    out.update(flip_launches=nonzero(read_counters()),
               flip_reruns=engine.cond_rerun_counter.count - reruns,
               flip_err=max_err(got, graph.eval(**flipped)[0]._data))
    xd = sym.var("xd")
    d = sym.Dropout(xd, p=0.5)
    n = xcv.numel()
    dg = sym.Group([sym.contrib.cond(sym.sum(d) > float(n), lambda: d * 2.0,
                                     lambda: d * 3.0), d])
    dex = dg.bind(dev, {"xd": nd.NDArray(torch.ones(n, device=dev))})
    bad = then = 0
    for _ in range(16):
        o, dv = [a._data for a in dex.forward(is_train=True)]
        took = bool(dv.sum() > n)
        then += took
        bad += int(not torch.equal(o, dv * (2.0 if took else 3.0)))
    out.update(dropout_forwards=16, dropout_then=then,
               dropout_branch_mismatches=bad,
               dropout_stats=dict(dex.stats))
    return out


def phase_bucketing_lstm(dev):
    """Path (c): LSTM PTB (``lstm_ptb``, 650 x 2, vocab 10000, tied, bf16;
    batch 32, dropout 0.5) through the legacy API: ``rnn.BucketSentenceIter``
    (buckets 10, 20, 35, ``invalid_label=0``, layout ``TN``) feeding
    ``BucketingModule(sym_gen, default_bucket_key=35)`` whose ``sym_gen``
    traces the model with Symbols under ``MakeLoss(mean(
    softmax_xent_rows))``, SGD lr 1.0 with fp32 masters, two epochs. One
    executor a bucket sharing the parameter and optimizer-state dicts, one
    forward and one backward capture each, 1/1 softmax-xent a step; each
    bucket's first loss within 1e-2 of the Gluon model's eager loss on the
    same batch from the same generator seed (the masks of the embedding,
    between-layer and output dropouts then agree) and its gradients within
    PR 14's LSTM limits. Then ``phase_control_flow`` at the same width."""
    import torch
    from mxnet_tpu_torch import amp, autograd, nd, rnn, sym
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.context import context_from_device
    from mxnet_tpu_torch.models.lstm_lm import lstm_ptb
    from mxnet_tpu_torch.module import BucketingModule
    from mxnet_tpu_torch.ops import F

    t_phase = time.perf_counter()
    V, N, H = LSTM_RECIPE["vocab"], LSTM_RECIPE["batch"], 650
    model = lstm_ptb(vocab_size=V, tie_weights=True, dropout=0.5)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    params = list(model.collect_params().values())
    ctx = context_from_device(dev)
    with ctx:
        it = rnn.BucketSentenceIter(
            _bucket_sentences(), N, buckets=list(LSTM_BUCKETS),
            invalid_label=0, label_name="label", layout="TN", dtype="int32")

    def sym_gen(T):
        data = sym.var("data", shape=(T, N), dtype="int32")
        states = [sym.zeros((2, N, H)), sym.zeros((2, N, H))]
        logits, _ = model(data, states)
        loss = sym.MakeLoss(sym.mean(sym.softmax_xent_rows(
            logits, sym.var("label"))))
        return loss, ("data",), ("label",)

    bm = BucketingModule(sym_gen, default_bucket_key=max(LSTM_BUCKETS),
                         context=ctx)
    bm.bind(it.provide_data, it.provide_label)
    bm.init_params(arg_params={p.name: nd.NDArray(p._tensor().detach()
                                                   .clone())
                               for p in params})
    bm.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 1.0, "multi_precision": True})
    rows, firsts, tokens35 = [], {}, None
    with ctx:
        for epoch in range(BUCKET_EPOCHS):
            it.reset()
            for batch in it:
                key = batch.bucket_key
                x, y = batch.data[0]._data, batch.label[0]._data
                if key == max(LSTM_BUCKETS):
                    tokens35 = x
                if key not in firsts:  # the Gluon model, the module's weights
                    with torch.no_grad():
                        for p in params:
                            p._tensor().copy_(bm._arg_params[p.name]._data)
                            p.zero_grad()
                    mx_random.seed(SEED + key)
                    with autograd.record():
                        ref = F.softmax_xent_rows(model(x), y).mean()
                    autograd.backward(ref)
                    firsts[key] = {"ref_loss": float(ref),
                                   "ref_grads": _grads_of(params)}
                    mx_random.seed(SEED + key)
                torch.cuda.synchronize()
                reset_counters()
                loss = float(bm.forward(batch, is_train=True)[0].asscalar())
                bm.backward()
                launches = read_counters()
                if "loss" not in firsts[key]:
                    ex = bm._curr_module._exec
                    grads = [ex.grad_dict[p.name]._data for p in params]
                    f = firsts.pop(key)
                    firsts[key] = {
                        "loss": loss, "ref_loss": f["ref_loss"],
                        "loss_abs_err": abs(loss - f["ref_loss"]),
                        "worst_grad_rel_l2": grad_rel_l2(
                            params, grads, f["ref_grads"])[0][0],
                        "worst_row_rel_l2": grad_row_rel_l2(
                            params, grads, f["ref_grads"])[0][0]}
                bm.update()
                rows.append({"epoch": epoch, "bucket": key, "loss": loss,
                             "launches": launches, "rows": int(x.numel())})
    shared = all(m._arg_params is bm._arg_params
                 and m._opt_states is bm._opt_states
                 for m in bm._buckets.values())
    stats = {k: dict(m._exec.stats) for k, m in sorted(bm._buckets.items())}
    control = phase_control_flow(dev, tokens35.to(dev))
    del bm, model
    torch.cuda.empty_cache()
    out = {"card": card_line(), "steps": rows, "first_steps": firsts,
           "buckets": sorted(stats), "shared_dicts": shared,
           "executor_stats": stats, "control_flow": control,
           "phase_seconds": time.perf_counter() - t_phase}
    print("bucketing lstm: lstm_ptb through BucketingModule, buckets %s, %d "
          "steps: losses %s; first steps against the Gluon model %s; "
          "executors %s, sharing the dicts %s; launches a step %s; %.1f s, "
          "%s" % (list(LSTM_BUCKETS), len(rows),
                  ["%.4f" % r["loss"] for r in rows],
                  {k: {n: "%.3g" % v for n, v in f.items()}
                   for k, f in firsts.items()}, stats, shared,
                  rows[0]["launches"], out["phase_seconds"], out["card"]),
          flush=True)
    for r in rows:
        ln = {k: v for k, v in r["launches"].items()
              if k not in ("softmax_xent_fwd", "softmax_xent_bwd")}
        check(r["launches"]["softmax_xent_fwd"] == 1
              and r["launches"]["softmax_xent_bwd"] == 1
              and not any(ln.values()),
              "bucketing lstm: launches %s" % r["launches"])
        check(np.isfinite(r["loss"]), "bucketing lstm: a loss not finite")
    check(sorted(stats) == sorted(LSTM_BUCKETS) and shared,
          "bucketing lstm: executors %s, shared %s" % (sorted(stats),
                                                       shared))
    for k, s in stats.items():
        check(s == {"forward_captures": 1, "backward_captures": 1,
                    "forward_replays": BUCKET_EPOCHS,
                    "backward_replays": BUCKET_EPOCHS, "recaptures": 0},
              "bucketing lstm: bucket %s executor %s" % (k, s))
    for k, f in firsts.items():
        check(f["loss_abs_err"] <= STEP_LOSS_TOL,
              "bucketing lstm: bucket %s first loss %.6f, Gluon %.6f"
              % (k, f["loss"], f["ref_loss"]))
        check(f["worst_grad_rel_l2"] <= A11_GRAD_TOL
              and f["worst_row_rel_l2"] <= A11_ROW_TOL,
              "bucketing lstm: bucket %s gradients %s" % (k, f))
    return out


def phase_get_symbol(dev):
    """Path (d): the NDArray GPT-2 small forward and loss
    (``phase_nd_train``'s recipe, recorded in predict mode so no dropout
    draws) through ``autograd.get_symbol``, bound and run on the card: its
    output equals the recorded loss bit for bit, with 25 LayerNorm, 12
    flash and 1 softmax-xent forward launches; ``tojson`` refuses it."""
    import torch
    from mxnet_tpu_torch import autograd, nd
    from mxnet_tpu_torch.context import context_from_device

    t_phase = time.perf_counter()
    step = GPTTrainStep(dev)
    ctx = context_from_device(dev)
    x = nd.NDArray(step.inp)
    y = nd.NDArray(step.tgt)
    with autograd.record(train_mode=False):
        loss = step.loss_fn(step.model(x), y)
    s = autograd.get_symbol(loss)
    args = s.list_arguments()
    ex = s.bind(ctx, {"arg0": x, "arg1": y})
    ex.forward(is_train=False)  # the capture
    torch.cuda.synchronize()
    reset_counters()
    got = ex.forward(is_train=False)[0]._data.clone()
    torch.cuda.synchronize()
    launches = read_counters()
    bitwise = bool(torch.equal(got, loss._data.detach()))
    try:
        s.tojson()
        refused = False
    except ValueError:
        refused = True
    del step, ex
    torch.cuda.empty_cache()
    L = GPT_CONFIG["num_layers"]
    want = {"layernorm": 2 * L + 1, "layernorm_bwd": 0,
            "flash_attention_fwd": L, "flash_attention_bwd": 0,
            "softmax_xent_fwd": 1, "softmax_xent_bwd": 0,
            "flash_attention_fwd_f32": 0}
    out = {"card": card_line(), "arguments": args, "bitwise": bitwise,
           "launches": launches, "tojson_refused": refused,
           "phase_seconds": time.perf_counter() - t_phase}
    print("get_symbol: GPT-2 small's recorded forward and loss as a Symbol "
          "over %s, bound on the card: equal to the recorded loss bit for "
          "bit %s; launches a forward %s; tojson refused %s; %.1f s, %s" % (
              args, bitwise, launches, refused, out["phase_seconds"],
              out["card"]), flush=True)
    check(args == ["arg0", "arg1"], "get_symbol: arguments %s" % args)
    check(bitwise, "get_symbol: the graph's output is not the recorded loss")
    check(launches == want, "get_symbol: launches %s" % launches)
    check(refused, "get_symbol: tojson accepted a host closure")
    return out


def run_slice19(dev):
    """The four paths of A.14's close and A.15's host I/O, each timed."""
    out = {}
    for name, phase in (("module_fit", phase_module_fit),
                        ("data_pipeline", phase_data_pipeline),
                        ("bucketing_lstm", phase_bucketing_lstm),
                        ("get_symbol", phase_get_symbol)):
        t0 = time.perf_counter()
        out[name] = phase(dev)
        out[name]["phase_seconds"] = time.perf_counter() - t0
    print("A.14/A.15 phases: %s s" % {
        k: round(v["phase_seconds"], 1) for k, v in out.items()}, flush=True)
    return out


IMAGE_LIB = os.path.join("src", "engine_cc", "libmxtpu_im.so")
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")


def phase_image_probe():
    """Which JPEG decoders this machine offers, on one line: whether the
    committed ``libmxtpu_im.so`` loads (its ``libjpeg.so.62`` resolves),
    whether PIL imports, and whether the CUDA toolkit has nvJPEG's header
    and library. The port's decode routes follow from it."""
    import ctypes
    import glob

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {}
    try:
        ctypes.CDLL(os.path.join(repo, IMAGE_LIB))
        out["libmxtpu_im"] = "loads"
    except OSError as e:
        out["libmxtpu_im"] = "fails: %s" % e
    try:
        import PIL

        out["PIL"] = "imports %s" % PIL.__version__
    except ImportError as e:
        out["PIL"] = "fails: %s" % e
    heads = sorted(glob.glob(os.path.join(CUDA_HOME, "include", "nvjpeg.h"))
                   + glob.glob(os.path.join(CUDA_HOME, "targets", "*",
                                            "include", "nvjpeg.h")))
    libs = sorted(glob.glob(os.path.join(CUDA_HOME, "lib64", "libnvjpeg.so*"))
                  + glob.glob(os.path.join(CUDA_HOME, "targets", "*", "lib",
                                           "libnvjpeg.so*")))
    out["nvjpeg_h"] = heads
    out["libnvjpeg"] = libs
    print("image probe: %s" % json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# Slice 20: A.15's image half feeding ResNet-50 and SSD-512, and A.16's
# observability core and profiler
# ---------------------------------------------------------------------------

IMAGE_FIXTURE = os.path.join("tests", "fixtures")
# the fixture's ImageRecordIter reading (tools/gen_torch_image_fixture.py)
IMAGE_FIXTURE_KW = dict(data_shape=(3, 224, 224), batch_size=16, resize=256,
                        rand_mirror=True, shuffle=True, mean_r=123.68,
                        mean_g=116.28, mean_b=103.53, std_r=58.395,
                        std_g=57.12, std_b=57.375)
IMAGE_RECORDS = 1024   # the repacked ImageNet-shaped file of path (a)
# paths (a) and (c): the crop and the shorter edge it is cut from
IMAGE_TRAIN = {"size": 224, "resize": 256}
IMAGE_STEPS = 8
IMAGE_THREADS = 8
DET_PAD = SSD_RECIPE["boxes"]  # label_pad_width: K fixed a batch
# ToTensor's 0-1 scale: ImageNet's mean and std
VISION_MEAN = (0.485, 0.456, 0.406)
VISION_STD = (0.229, 0.224, 0.225)
LOADER_BATCHES = 2
LOADER_THREADS = 4
LOADER_PROCS = 2
OBS_REQUESTS = 24
OBS_BUCKETS_RETUNED = (2, 4, 8)   # a planted retune: captures 2 and the
OBS_STREAMS = 8                   # two others again
OBS_NEW_TOKENS = 8

_slice20_tmp = []


def _slice20_dir():
    """One scratch directory for slice 20's record files (under the
    ignored build directory), removed by ``run_slice20``."""
    import tempfile

    from mxnet_tpu_torch.ops.cuda import _build

    if not _slice20_tmp:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        _slice20_tmp.append(tempfile.mkdtemp(prefix="slice20_",
                                             dir=_build.BUILD_DIR))
    return _slice20_tmp[0]


def _fixture(name):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        IMAGE_FIXTURE, name)


def _image_ref():
    return np.load(_fixture("torch_images_ref.npz"))


def image_digest(data, labels):
    """The fixture's digest: sha256 of the float32 data bytes, then the
    float32 label bytes."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(data, np.float32).tobytes())
    h.update(np.ascontiguousarray(labels, np.float32).tobytes())
    return h.hexdigest()


def _sha(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a, np.uint8)
                          .tobytes()).hexdigest()


def repack_records(src_name, n, seed, det=False):
    """``n`` records cycling the fixture's JPEG payloads (the card has no
    encoder), each with a seeded class below ``RESNET["classes"]`` (or,
    ``det``, its own detection label, each class taken modulo
    ``SSD_RECIPE["classes"]``), written by ``recordio.pack``; returns the
    path."""
    from mxnet_tpu_torch import recordio

    dst = os.path.join(_slice20_dir(), "%s_%d.rec" % (src_name, n))
    if os.path.exists(dst):
        return dst
    src = recordio.RecordSource(_fixture(src_name + ".rec"))
    rng = np.random.RandomState(seed)
    w = recordio.MXIndexedRecordIO(dst[:-4] + ".idx", dst, "w")
    for i in range(n):
        header, payload = src.read(i % len(src))
        if det:
            label = np.array(header.label, np.float32)
            hw, ow = int(label[0]), int(label[1])
            label[hw::ow] %= SSD_RECIPE["classes"]
        else:
            label = float(rng.randint(0, RESNET["classes"]))
        w.write_idx(i, recordio.pack(recordio.IRHeader(0, label, i, 0),
                                     payload))
    w.close()
    return dst


def _on_device_context(phase):
    """Run ``phase(dev, ...)`` with ``dev`` the current context, where the
    iterators and loaders make their batches (on the card it is the
    default already)."""
    import functools

    @functools.wraps(phase)
    def run(dev, *args, **kw):
        from mxnet_tpu_torch.context import context_from_device

        with context_from_device(dev):
            return phase(dev, *args, **kw)

    return run


def _chroma_swapped(a):
    """The planted decode fault: Cb and Cr exchanged."""
    from PIL import Image

    y, cb, cr = Image.fromarray(a).convert("YCbCr").split()
    return np.asarray(Image.merge("YCbCr", (y, cr, cb)).convert("RGB"))


def phase_image_decode(dev):
    """Path (d): each fixture record's decode on this machine against the
    JAX package's PIL decode (sha256 of the pixels, bit for bit), the
    decode counted by route; a planted chroma swap must part from every
    record."""
    from mxnet_tpu_torch import image, io, recordio

    ref = _image_ref()
    out = {"decode_route": image.decode_route(),
           "native_pipeline": io.image_native_error() or "loads"}
    check(out["decode_route"] is not None, "no JPEG decoder on this machine")
    n0 = image.counters["decode_pil"]
    t0 = time.perf_counter()
    for name, key in (("torch_images", "decode_sha"),
                      ("torch_images_det", "det_decode_sha")):
        src = recordio.RecordSource(_fixture(name + ".rec"))
        same, planted = [], []
        for i in range(len(src)):
            a = image.imdecode(src.read(i)[1]).asnumpy()
            same.append(_sha(a) == str(ref[key][i]))
            planted.append(_sha(_chroma_swapped(a)) == str(ref[key][i]))
        out[name] = {"records": len(src), "bit_equal": int(sum(same)),
                     "planted_fault_equal": int(sum(planted))}
        check(all(same), "%s: %d of %d decodes part from the JAX package's"
              % (name, len(same) - sum(same), len(same)))
        check(not any(planted), "%s: the planted chroma swap matched %d "
              "records" % (name, sum(planted)))
    out["decodes_counted"] = image.counters["decode_pil"] - n0
    out["seconds"] = time.perf_counter() - t0
    check(out["decodes_counted"] == 32, "decodes counted %d != 32"
          % out["decodes_counted"])
    print("image decode (d): route %s, native pipeline %s; %s" % (
        out["decode_route"], out["native_pipeline"],
        {k: out[k] for k in ("torch_images", "torch_images_det")}),
        flush=True)
    return out


def _device_allocs(dev):
    import torch

    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("allocation.all.allocated", 0)


def _fixture_batch_route():
    """The fixture's own file read as the fixture tool reads it, by the
    route this machine takes: (route, reason, digest, the fixture's
    digest for that route)."""
    from mxnet_tpu_torch import cpu, io

    ref = _image_ref()
    np.random.seed(int(ref["iter_seed"]))
    with cpu():
        it = io.ImageRecordIter(_fixture("torch_images.rec"),
                                preprocess_threads=IMAGE_THREADS,
                                **IMAGE_FIXTURE_KW)
        b = it.next()
    got = image_digest(b.data[0].asnumpy(), b.label[0].asnumpy())
    # the Python route here: the native library does not load, and the
    # iterator drew the pipe's seed before it found that out
    want = str(ref["jax_native_batch0"] if it.route == "native"
               else ref["port_fallback_batch0"])
    return it.route, it.route_reason, got, want


@_on_device_context
def phase_image_record_resnet(dev, step=None):
    """Path (a): ResNet-50 (``RESNET``, bf16, ``RESNET_SGD``) fed by
    ``ImageRecordIter(data_shape=(3, 224, 224), resize=256,
    rand_mirror=True)`` with ImageNet's mean and std, ``shuffle=True`` and
    8 ``preprocess_threads``, over IMAGE_RECORDS records repacked from the
    fixture, IMAGE_STEPS steps. Before it the fixture's own file gives the
    fixture's digest by this machine's route; the first loss is bit for
    bit the same step's fed the same batch directly; 1 + 1 softmax-xent
    launches a step and no other kernel; finite losses, weights that move;
    decoding and augmenting an image allocates nothing on the card."""
    import torch
    from mxnet_tpu_torch import image, io
    from mxnet_tpu_torch import random as mx_random

    out = {}
    route, reason, got, want = _fixture_batch_route()
    out["fixture_route"], out["fixture_route_reason"] = route, reason
    out["fixture_digest_equal"] = got == want
    print("image record (a): the fixture's first batch by the %s route "
          "(%s): digest %s the fixture's" % (
              route, reason or "the native pipeline loads",
              "equals" if got == want else "PARTS FROM"), flush=True)
    check(got == want, "the fixture's first batch by the %s route parts "
          "from the fixture's digest" % route)
    path = repack_records("torch_images", IMAGE_RECORDS, SEED + 51)
    S = IMAGE_TRAIN["size"]
    kw = dict(IMAGE_FIXTURE_KW, batch_size=RESNET["batch"],
              data_shape=(3, S, S), resize=IMAGE_TRAIN["resize"],
              preprocess_threads=IMAGE_THREADS)
    # one image decoded and augmented: nothing on the card
    from mxnet_tpu_torch import recordio

    payload = recordio.RecordSource(_fixture("torch_images.rec")).read(0)[1]
    augs = image.CreateAugmenter((3, S, S), resize=IMAGE_TRAIN["resize"],
                                 rand_mirror=True, mean=True, std=True)
    a0 = _device_allocs(dev)
    img = image.imdecode(payload)
    for aug in augs:
        img = aug(img)
    out["image_device_allocs"] = _device_allocs(dev) - a0
    out["image_on"] = str(img._data.device)
    check(out["image_device_allocs"] == 0 and out["image_on"] == "cpu",
          "decoding and augmenting one image touched the card: %d "
          "allocations, the image on %s" % (out["image_device_allocs"],
                                            out["image_on"]))
    if step is None:
        step = ResNetTrainStep(dev)
    # the same batch fed directly: the host numpy of the same iterator
    np.random.seed(SEED + 52)
    data, labels = io.ImageRecordIter(path, **kw).host_batch()
    saved = step.saved_stats()
    step.x = torch.from_numpy(data).to(dev)
    step.y = torch.from_numpy(labels).to(dev).to(torch.int32)
    mx_random.seed(SEED)
    direct = step(update=False).float().mean()
    step.restore_stats(saved)
    watch = [step.params[0], step.params[-1]]
    before = [p._tensor().detach().clone() for p in watch]
    np.random.seed(SEED + 52)
    it = io.ImageRecordIter(path, **kw)
    out["route"], out["route_reason"] = it.route, it.route_reason
    counted0 = dict(io.counters)
    mx_random.seed(SEED)
    losses, iter_ms, step_ms = [], [], []
    reset_counters()
    for _ in range(IMAGE_STEPS):
        t0 = time.perf_counter()
        b = it.next()
        t1 = time.perf_counter()
        step.x = b.data[0]._data
        step.y = b.label[0]._data.to(torch.int32)
        losses.append(step().float().mean())
        torch.cuda.synchronize()
        iter_ms.append((t1 - t0) * 1e3)
        step_ms.append((time.perf_counter() - t1) * 1e3)
    launches = read_counters()
    losses = [float(v) for v in losses]
    out.update(losses=losses, launches=launches,
               iter_ms_per_batch=iter_ms, step_ms=step_ms,
               iter_ms_median=float(np.median(iter_ms)),
               step_ms_median=float(np.median(step_ms)),
               batches_by_route={k: io.counters[k] - counted0[k]
                                 for k in ("image_native", "image_python")},
               first_loss_bit_equal=bool(float(direct) == losses[0]))
    print("image record (a): resnet50 fed by ImageRecordIter (%s route, %s)"
          ": losses %s; launches %s; iterator %.1f ms a batch against the "
          "step's %.1f ms (medians); batches by route %s" % (
              it.route, it.route_reason, ["%.4f" % v for v in losses],
              launches, out["iter_ms_median"], out["step_ms_median"],
              out["batches_by_route"]), flush=True)
    check(out["first_loss_bit_equal"], "(a) the first loss %r is not the "
          "directly fed step's %r" % (losses[0], float(direct)))
    check(all(np.isfinite(losses)), "(a) non-finite loss")
    for p, b0 in zip(watch, before):
        check(not torch.equal(p._tensor(), b0), "(a) %s did not move"
              % p.name)
    for name, n in launches.items():
        want_n = RESNET_STEP_LAUNCHES.get(name, 0) * IMAGE_STEPS
        check(n == want_n, "(a) %s launches %d != %d" % (name, n, want_n))
    check(out["batches_by_route"]["image_%s" % it.route] == IMAGE_STEPS,
          "(a) batches not counted by their route: %s"
          % out["batches_by_route"])
    return step, out


@_on_device_context
def phase_image_det_ssd(dev):
    """Path (b): SSD-512 (``SSD_RECIPE``) fed by ``ImageDetRecordIter(
    rand_crop=1, rand_pad=1, rand_mirror=True, label_pad_width=DET_PAD)``
    over the fixture's detection records repacked (the Python route): the
    labels (B, K, 5) with -1 padding rows and every real box in [0, 1];
    the first loss bit for bit the same step's fed the same batch
    directly; no kernel launches; the last of SSD_STEPS losses under the
    first."""
    import torch
    from mxnet_tpu_torch import io
    from mxnet_tpu_torch import random as mx_random

    B = SSD_RECIPE["batch"]
    path = repack_records("torch_images_det", B * SSD_STEPS, SEED + 53,
                          det=True)
    S = SSD_RECIPE["size"]
    kw = dict(data_shape=(3, S, S), batch_size=B, rand_crop=1, rand_pad=1,
              rand_mirror=True, label_pad_width=DET_PAD, mean_r=123.68,
              mean_g=116.28, mean_b=103.53, std_r=58.395, std_g=57.12,
              std_b=57.375, preprocess_threads=IMAGE_THREADS)
    step = SSDTrainStep(dev)
    np.random.seed(SEED + 54)
    data, labels = io.ImageDetRecordIter(path, **kw).host_batch()
    real = labels[..., 0] >= 0
    out = {"label_shape": list(labels.shape),
           "padding_rows_all_minus_one": bool((labels[~real] == -1).all()),
           "real_boxes_in_unit": bool(((labels[real][:, 1:] >= 0)
                                       & (labels[real][:, 1:] <= 1)).all()),
           "objects_a_batch": int(real.sum())}
    check(out["label_shape"] == [B, DET_PAD, 5], "(b) labels %s"
          % out["label_shape"])
    check(out["padding_rows_all_minus_one"] and out["real_boxes_in_unit"],
          "(b) label layout: %s" % out)
    step.x = torch.from_numpy(data).to(dev)
    step.labels = torch.from_numpy(labels).to(dev)
    mx_random.seed(SEED)
    direct = step(update=False).float()
    np.random.seed(SEED + 54)
    it = io.ImageDetRecordIter(path, **kw)
    counted0 = io.counters["image_python"]
    mx_random.seed(SEED)
    losses, iter_ms = [], []
    reset_counters()
    for _ in range(SSD_STEPS):
        t0 = time.perf_counter()
        b = it.next()
        iter_ms.append((time.perf_counter() - t0) * 1e3)
        step.x = b.data[0]._data
        step.labels = b.label[0]._data
        losses.append(step().float())
    launches = read_counters()
    losses = [float(v) for v in losses]
    out.update(losses=losses, launches=launches, iter_ms_per_batch=iter_ms,
               iter_ms_median=float(np.median(iter_ms)),
               batches_python_route=io.counters["image_python"] - counted0,
               first_loss_bit_equal=bool(float(direct) == losses[0]))
    print("image det (b): ssd512 fed by ImageDetRecordIter: losses %s; "
          "launches %s; iterator %.1f ms a batch (median); label %s, %d "
          "objects in the first batch" % (
              ["%.4f" % v for v in losses],
              {k: v for k, v in launches.items() if v},
              out["iter_ms_median"], out["label_shape"],
              out["objects_a_batch"]), flush=True)
    check(out["first_loss_bit_equal"], "(b) the first loss %r is not the "
          "directly fed step's %r" % (losses[0], float(direct)))
    check(all(np.isfinite(losses)), "(b) non-finite loss")
    check(not any(launches.values()), "(b) the ssd512 step launched %s"
          % launches)
    check(losses[-1] < losses[0], "(b) the ssd512 loss did not fall: %s"
          % losses)
    check(out["batches_python_route"] == SSD_STEPS, "(b) batches counted "
          "%d != %d" % (out["batches_python_route"], SSD_STEPS))
    return out


def _loader_batches(loader, n):
    got = []
    for i, b in enumerate(loader):
        if i >= n:
            break
        got.append(b)
    return got


@_on_device_context
def phase_vision_loader(dev, step):
    """Path (c): ResNet-50 through ``gluon.Trainer`` fed by
    ``ImageRecordDataset`` with ``transforms.Compose([RandomResizedCrop(224),
    RandomFlipLeftRight(), ToTensor(), Normalize(...)])``,
    ``DataLoader(batch 128, pin_memory=True)`` and its DevicePrefetcher:
    at ``num_workers=0`` each batch byte for byte the same loader's on the
    CPU under the same numpy seed, 1 + 1 softmax-xent launches a step;
    then a deterministic ``Resize`` + ``CenterCrop`` chain through 4
    thread workers and 2 process workers, byte for byte against the CPU
    (random transforms draw from one global numpy state in no fixed order
    across workers, as in the JAX package)."""
    import torch
    from mxnet_tpu_torch import cpu
    from mxnet_tpu_torch import random as mx_random
    from mxnet_tpu_torch.gluon import data as gdata
    from mxnet_tpu_torch.gluon.data.vision import transforms as T

    B = RESNET["batch"]
    path = repack_records("torch_images", IMAGE_RECORDS, SEED + 51)
    ds = gdata.vision.ImageRecordDataset(path)
    S = IMAGE_TRAIN["size"]
    rand_chain = T.Compose([T.RandomResizedCrop(S), T.RandomFlipLeftRight(),
                            T.ToTensor(), T.Normalize(VISION_MEAN,
                                                      VISION_STD)])
    det_chain = T.Compose([T.Resize(IMAGE_TRAIN["resize"]), T.CenterCrop(S),
                           T.ToTensor(), T.Normalize(VISION_MEAN, VISION_STD)])

    def loader(chain, **kw):
        return gdata.DataLoader(
            ds.transform_first(chain), batch_sampler=gdata.BatchSampler(
                gdata.SequentialSampler(LOADER_BATCHES * B), B, "discard"),
            **kw)

    def host(batches):
        return [[a.asnumpy() for a in b] for b in batches]

    def same(a, b):
        return all(x.dtype == y.dtype and x.shape == y.shape
                   and x.tobytes() == y.tobytes()
                   for ba, bb in zip(a, b) for x, y in zip(ba, bb)) \
            and len(a) == len(b)

    out = {}
    np.random.seed(SEED + 55)
    with cpu():
        want = host(_loader_batches(loader(rand_chain), LOADER_BATCHES))
    np.random.seed(SEED + 55)
    t0 = time.perf_counter()
    got = _loader_batches(loader(rand_chain, pin_memory=True),
                          LOADER_BATCHES)
    out["serial_seconds"] = time.perf_counter() - t0
    out["serial_on"] = str(got[0][0]._data.device)
    out["serial_byte_equal"] = same(host(got), want)
    mx_random.seed(SEED)
    reset_counters()
    losses = []
    for x, y in got:
        step.x = x._data
        step.y = y._data.to(torch.int32)
        losses.append(float(step().float().mean()))
    out["losses"], out["launches"] = losses, read_counters()
    for name, n in out["launches"].items():
        want_n = RESNET_STEP_LAUNCHES.get(name, 0) * LOADER_BATCHES
        check(n == want_n, "(c) %s launches %d != %d" % (name, n, want_n))
    check(out["serial_byte_equal"], "(c) the num_workers=0 batches part "
          "from the CPU's")
    check(all(np.isfinite(losses)), "(c) non-finite loss")
    with cpu():
        want_det = host(_loader_batches(loader(det_chain), LOADER_BATCHES))
    for label, kw in (("threads", {"num_workers": LOADER_THREADS}),
                      ("processes", {"num_workers": LOADER_PROCS,
                                     "thread_pool": False})):
        ld = loader(det_chain, pin_memory=True, **kw)
        t0 = time.perf_counter()
        try:
            got = host(_loader_batches(ld, LOADER_BATCHES))
            out[label] = {"seconds": time.perf_counter() - t0,
                          "byte_equal": same(got, want_det),
                          "worker_reports": ld.worker_reports}
        finally:
            ld.close()
        check(out[label]["byte_equal"], "(c) the %s loader's batches part "
              "from the CPU's" % label)
    for r in out["processes"]["worker_reports"]:
        check(r["device_count"] == 0, "(c) a process worker saw a card: %s"
              % r)
    print("vision loader (c): batches on %s, num_workers=0 byte-equal %s "
          "(%.1f s for %d batches); losses %s, launches %s; thread workers "
          "%s, process workers %s" % (
              out["serial_on"], out["serial_byte_equal"],
              out["serial_seconds"], LOADER_BATCHES, losses, out["launches"],
              out["threads"]["byte_equal"], out["processes"]["byte_equal"]),
          flush=True)
    return out


def _scrape(url):
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as r:
        text = r.read().decode()
    samples = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, _, value = line.rpartition(" ")
            samples[name] = float(value)
    return samples


def _trace_reading(handles):
    """Each handle's spans in order (queue, coalesce, pad, dispatch), each
    starting where the last ended or later, and their sum within the
    request's latency."""
    bad = []
    for h, lat_s in handles:
        spans = h.trace.spans
        names = [s[0] for s in spans]
        ordered = names == ["queue", "coalesce", "pad", "dispatch"] and all(
            b[1] >= a[2] - 1e-9 for a, b in zip(spans, spans[1:]))
        total = sum(s[2] - s[1] for s in spans)
        if not ordered or total > lat_s:
            bad.append({"spans": names, "sum_s": total, "latency_s": lat_s})
    return bad


def phase_observability(dev):
    """Path (e): BERT-base served at ``phase_serve``'s recipe with
    ``metrics_port=0`` and tracing: a burst of OBS_REQUESTS requests; the
    scrape of ``/metrics`` gives ``stats()``'s counts; every trace's
    stages in order and within its latency; the watchdog, armed after
    warmup, 0 events in traffic and one event naming each bucket a
    planted ``retune_buckets`` captures. GPT-2 small's
    ``GenerativeServer``: its TTFT histogram counts each stream once.
    ``profiler.start``/``stop`` around two served batches: the Chrome
    trace holds the serve scopes, and its LayerNorm and flash-forward
    kernel events count what the launch counters count."""
    import json as _json

    import torch
    from mxnet_tpu_torch import amp, observability, profiler
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    out = {}
    model = bert_base(dropout=0.1, max_length=SEQ)
    model.initialize(device=dev,
                     generator=torch.Generator(device=dev).manual_seed(SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    specs = [((SEQ,), "int32"), ((SEQ,), "int32"), ((), "int32")]
    observability.set_tracing(True)
    srv = ModelServer(model, specs, buckets=BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, device=dev, metrics_port=0,
                      name="serve:observability")
    observability.watchdog.reset_events()
    observability.arm_watchdog()
    rng = np.random.RandomState(SEED + 56)
    vl = rng.randint(1, SEQ + 1, OBS_REQUESTS).astype(np.int32)
    tok = rng.randint(0, VOCAB, (OBS_REQUESTS, SEQ)).astype(np.int32)
    tt = (np.arange(SEQ)[None, :] >= vl[:, None] // 2).astype(np.int32)
    try:
        with srv:
            handles = [srv.submit(tok[i], tt[i], vl[i])
                       for i in range(OBS_REQUESTS)]
            done = []
            for h in handles:
                h.result(timeout_s=300)
                done.append((h, time.perf_counter() - h.t_submit))
            traffic_events = observability.watchdog.snapshot()["events"]
            stats = srv.stats()
            scraped = _scrape(srv.metrics_http.url())
            label = '{server="%s"}' % srv.name
            keys = ("requests", "completed", "batches", "captures",
                    "replays")
            out["scrape"] = {k: [stats[k], scraped.get(
                "mxtpu_serve_server_%s%s" % (k, label))] for k in keys}
            out["trace_faults"] = _trace_reading(done)
            out["trace_example"] = done[0][0].timing()
            # two served batches under the profiler
            profiler.set_config(filename=os.path.join(
                _slice20_dir(), "profile.json"), aggregate_stats=True)
            reset_counters()
            profiler.start()
            for lo, hi in ((0, 8), (8, 16)):
                hs = [srv.submit(tok[i], tt[i], vl[i]) for i in range(lo, hi)]
                for h in hs:
                    h.result(timeout_s=300)
            profiler.stop()
            launches = read_counters()
        trace = _json.load(open(profiler.dump()))["traceEvents"]
        table = profiler.dumps(reset=True)
        kernels = [e["name"] for e in trace if e["cat"] == "kernel"]
        out["profile"] = {
            "serve_scopes": sum(e["name"].startswith("serve[")
                                for e in trace),
            "request_spans": sum(e["cat"] == "request" for e in trace),
            "layernorm_events": sum(_kernel_class(k) == "layernorm"
                                    for k in kernels),
            "flash_events": sum(_kernel_class(k) == "flash"
                                for k in kernels),
            "launches": launches, "kernel_events": len(kernels),
            "table_lines": len(table.splitlines())}
        # the planted retune: one event for each bucket it captures
        observability.watchdog.reset_events()
        srv.retune_buckets(OBS_BUCKETS_RETUNED)
        events = list(observability.watchdog.events)
        out["retune_events"] = [e["key"] for e in events]
    finally:
        observability.disarm_watchdog()
        srv.stop()
    out["traffic_events"] = traffic_events
    # GPT-2 small's GenerativeServer: one TTFT observation a stream
    gmodel = _gpt_model(dev, SEED + 57)
    gen = _gen_server(gmodel, dev, metrics_port=0, name="gen:observability")
    gen.warmup(prompt_buckets=(64,), max_tokens=128)
    n0 = gen.stats()["ttft_count"]
    prng = np.random.RandomState(SEED + 58)
    with gen:
        streams = [gen.submit(prng.randint(0, GPT_VOCAB, 40 + 3 * i),
                              max_new_tokens=OBS_NEW_TOKENS)
                   for i in range(OBS_STREAMS)]
        for s in streams:
            s.result(timeout_s=300)
        g = gen.stats()
        gscraped = _scrape(gen.metrics_http.url())
    out["ttft"] = {"count": g["ttft_count"] - n0,
                   "scraped": gscraped.get('mxtpu_serve_server_ttft_count'
                                           '{server="%s"}' % gen.name),
                   "stats_count": g["ttft_count"],
                   "decode_spans": sum(
                       1 for s in streams for sp in s.trace.spans
                       if sp[0] == "decode")}
    del gen, gmodel
    print("observability (e): scrape vs stats %s; trace faults %d of %d "
          "(first: %s); watchdog events in traffic %d, after the planted "
          "retune %s; profiler: %s; TTFT %s" % (
              out["scrape"], len(out["trace_faults"]), OBS_REQUESTS,
              out["trace_example"], out["traffic_events"],
              out["retune_events"], out["profile"], out["ttft"]), flush=True)
    for k, (want, got) in out["scrape"].items():
        check(got == want, "(e) scraped %s %r != stats() %r" % (k, got,
                                                                want))
    check(not out["trace_faults"], "(e) traces out of order or over their "
          "latency: %s" % out["trace_faults"][:3])
    check(out["traffic_events"] == 0, "(e) the watchdog saw %d events in "
          "traffic" % out["traffic_events"])
    want_keys = ["serve[%s bucket=%d]" % (srv.name, b)
                 for b in sorted(OBS_BUCKETS_RETUNED, reverse=True)]
    check(sorted(out["retune_events"]) == sorted(want_keys),
          "(e) the retune's watchdog events %s != %s"
          % (out["retune_events"], want_keys))
    p = out["profile"]
    check(p["serve_scopes"] >= 2, "(e) %d serve scopes in the trace"
          % p["serve_scopes"])
    check(p["layernorm_events"] == launches.get("layernorm", 0)
          and p["flash_events"] == launches.get("flash_attention_fwd", 0)
          and p["layernorm_events"] > 0,
          "(e) the trace's kernel events (layernorm %d, flash %d) do not "
          "count the launches %s" % (p["layernorm_events"],
                                     p["flash_events"], launches))
    check(out["ttft"]["count"] == OBS_STREAMS
          and out["ttft"]["scraped"] == out["ttft"]["stats_count"],
          "(e) the TTFT histogram counts %s for %d streams"
          % (out["ttft"], OBS_STREAMS))
    return out


def run_slice20(dev):
    """Slice 20's paths, each timed: (d) decode, (a) ImageRecordIter into
    ResNet-50, (b) ImageDetRecordIter into SSD-512, (c) the vision
    DataLoader, (e) observability and the profiler."""
    out = {}
    try:
        t0 = time.perf_counter()
        out["image_probe"] = phase_image_probe()
        out["decode"] = phase_image_decode(dev)
        out["decode"]["phase_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, out["image_record_resnet"] = phase_image_record_resnet(dev)
        out["image_record_resnet"]["phase_seconds"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        out["vision_loader"] = phase_vision_loader(dev, step)
        out["vision_loader"]["phase_seconds"] = time.perf_counter() - t0
        del step
        for name, phase in (("image_det_ssd", phase_image_det_ssd),
                            ("observability", phase_observability)):
            t0 = time.perf_counter()
            out[name] = phase(dev)
            out[name]["phase_seconds"] = time.perf_counter() - t0
    finally:
        for d in _slice20_tmp:
            shutil.rmtree(d, ignore_errors=True)
        del _slice20_tmp[:]
    print("A.15 image / A.16 phases: %s s" % {
        k: round(v["phase_seconds"], 1) for k, v in out.items()
        if "phase_seconds" in v}, flush=True)
    return out


def card_line():
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except OSError as e:
        return "nvidia-smi failed: %s" % e
    return smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        "nvidia-smi failed: %s" % smi.stderr.strip()


def print_optimizer_summary(optim, gpt_train, card):
    """The GPT-2 step's optimizer range on the device (torch.profiler)
    under Adam, SGD with the cosine schedule and LAMB, with each step's
    host wall, on one line with the card."""
    key = "mxnet_tpu_torch::optimizer_step"
    rows = [("adam", gpt_train)] + list(optim["gpt2_steps"].items())
    print("gpt2 train step on %s: %s" % (card, "; ".join(
        "%s: host wall %.3f ms, optimizer range %.3f ms on the device" % (
            label, r["step_wall_ms_median"],
            r["breakdown"]["range_device_ms_per_step"].get(key, 0.0))
        for label, r in rows)), flush=True)


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "mxnet_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository "
              "(mxnet_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, repo)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)),
          flush=True)
    t_start = time.perf_counter()
    try:
        phase_build()
        ln_fwd, ln_bwd = phase_layernorm(dev)
        checks = {"layernorm": ln_fwd, "layernorm_bwd": ln_bwd,
                  "flash_attention_fwd": phase_flash(dev),
                  "flash_attention_fwd_f32": phase_flash_f32(dev),
                  "softmax_xent": phase_xent(dev),
                  "flash_attention_bwd": phase_flash_bwd(dev)}
        # each record carries the error of its case at the bert512 step's
        # shape, the first of each phase
        errs = {k: checks[k][0]["max_abs_err"]
                for k in ("layernorm", "flash_attention_fwd",
                          "flash_attention_fwd_f32")}
        xent0 = checks["softmax_xent"][0]
        bwd0 = checks["flash_attention_bwd"][0]
        errs.update({"layernorm_bwd": max(ln_bwd[0][n]["max_abs_err"]
                                          for n in ("dx", "dgamma", "dbeta")),
                     "softmax_xent_fwd": xent0["fwd"]["max_abs_err"],
                     "softmax_xent_bwd": xent0["bwd"]["max_abs_err"],
                     "flash_attention_bwd": max(
                         bwd0[n]["max_abs_err"] for n in ("dq", "dk", "dv"))})
        model, serve_launches, forwards, serve_vl, serving, bert_srv = \
            phase_serve(dev)
        serve_graph = {"bf16": phase_serve_graph(dev, bert_srv,
                                                 "bf16 BERT server")}
        del bert_srv
        step, train = phase_train(dev)
        bert128 = phase_bert128(dev)
        gpt_step, gpt_train = phase_gpt_train(dev)
        nd_phases = {}
        for name, phase in (("phase_nd_train", phase_nd_train),
                            ("phase_nd_ops", phase_nd_ops),
                            ("phase_create_graph", phase_create_graph)):
            t0 = time.perf_counter()
            nd_phases[name] = phase(dev)
            nd_phases[name]["phase_seconds"] = time.perf_counter() - t0
        print("nd phases: %s s" % {k: round(v["phase_seconds"], 1)
                                   for k, v in nd_phases.items()},
              flush=True)
        optim = {"one_step": phase_optimizers(dev)}
        optim_steps, optim["gpt2_steps"] = phase_gpt_train_optimizers(dev)
        gen_srv, gen_model, gen = phase_generate(dev)
        check_generate_launches(gen)
        gen["single_requests"] = phase_generate_launches(dev, gen_srv)
        gen_srv.stop()
        del gen_srv
        bad_ids = phase_bad_ids(dev, gen_model)
        graphs = phase_graph(dev)
        spec, plains = phase_speculative(dev)
        chunked = phase_chunked_prefill(dev, plains)
        del plains
        print_spec_summary(spec, chunked, card)
        lowbit = phase_lowbit(dev)
        quant_model, quant = phase_generate_quant(dev)
        quant["products"] = lowbit
        quant["bert_int8_serving"], bert_int8, qsrv = phase_serve_quant(dev)
        serve_graph["int8"] = phase_serve_graph(dev, qsrv, "int8 BERT server",
                                                "int8")
        del qsrv
        snapshots = phase_snapshot(dev)
        vision_s = {}
        t0 = time.perf_counter()
        resnet_step, resnet = phase_resnet_train(dev)
        vision_s["phase_resnet_train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        resnet["serving"] = phase_resnet_serve(dev, resnet_step.net)
        vision_s["phase_resnet_serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        zoo = phase_vision_zoo(dev)
        vision_s["phase_vision_zoo"] = time.perf_counter() - t0
        resnet["phase_seconds"] = vision_s
        print("vision phases: %s, %.1f s together" % (
            {k: round(v, 1) for k, v in vision_s.items()},
            sum(vision_s.values())), flush=True)
        a11_steps, a11 = run_a11(dev)
        t0 = time.perf_counter()
        converted = phase_convert(dev)
        converted["phase_seconds"] = time.perf_counter() - t0
        dist_train = phase_dist_train(dev)
        model_parallel = phase_model_parallel(dev)
        tp_compute = phase_tp_compute(dev)
        hybridize = phase_hybridize(dev)
        symbolic = {}
        for name, phase in (("library_ops", phase_library_ops),
                            ("bulk", phase_bulk),
                            ("tape_replay", phase_tape_replay),
                            ("symbol_serve", phase_symbol_serve),
                            ("symbol_train", phase_symbol_train)):
            t0 = time.perf_counter()
            symbolic[name] = phase(dev)
            symbolic[name]["phase_seconds"] = time.perf_counter() - t0
        print("A.13/A.14 phases: %s s" % {
            k: round(v["phase_seconds"], 1) for k, v in symbolic.items()},
            flush=True)
        slice19 = run_slice19(dev)
        records, crossover = phase_timing(
            dev, train["launches"], train["steps_counted"], errs,
            serve_launches, forwards, serve_vl)
        records += phase_train_timing(dev, train["launches"], errs,
                                      train["steps_counted"])
        train_crossover = phase_train_crossover(dev)
        phase_generate_timing(dev, records, gen)
        phase_quant_timing(dev, records, quant)
        phase_gpt_train_timing(dev, records, gpt_train)
        phase_resnet_timing(dev, records, resnet)
        phase_a11_timing(dev, records, a11["lstm_train"], a11["nmt_train"])
        # the profiler windows come last: once a profiler session has run,
        # an eager step's host wall may not return to what it was before
        breakdown = phase_breakdown(dev, model)
        train["breakdown"] = phase_train_breakdown(step)
        gpt_train["breakdown"] = phase_train_breakdown(
            gpt_step, label="gpt2 train step")
        del gpt_step
        dist_train["breakdown"] = phase_dist_breakdown(dev)
        resnet["breakdown"] = phase_resnet_breakdown(resnet_step)
        del resnet_step
        a11_breakdowns(a11_steps, a11)
        del a11_steps
        for label, st in optim_steps.items():
            optim["gpt2_steps"][label]["breakdown"] = phase_train_breakdown(
                st, label="gpt2 train step, %s" % label)
        del optim_steps
        print_optimizer_summary(optim, gpt_train, card)
        gen["breakdown"] = phase_generate_breakdown(dev, gen_model)
        quant["breakdown"] = phase_generate_breakdown(dev, quant_model,
                                                      quantize="int8")
        quant["bert_int8_serving"]["breakdown_bucket_8"] = \
            phase_serve_quant_breakdown(*bert_int8)
        spec["breakdown"] = phase_speculative_breakdown(dev)
        del bert_int8
        for r in records:
            if r["name"] == "flash_attention_bwd":
                r["dq_pass_share"] = train["breakdown"][
                    "flash_bwd_dq_pass_share"]
        wall, _ = step.timed(TIMED_STEPS)
        train["step_wall_ms_median_after_profiler"] = wall
        print("bert512 step after the profiler sessions: median wall %.3f ms"
              % wall, flush=True)
        # after the timings too: phase_observability runs a profiler
        # session
        slice20 = run_slice20(dev)
    except SmokeFailure as e:
        print("chip_smoke FAILED: %s" % e, file=sys.stderr)
        return 1
    print("total: %.1f s" % (time.perf_counter() - t_start))
    print(json.dumps({"checks": checks, "serving": serving,
                      "breakdown": breakdown, "train_bert512": train,
                      "train_bert128": bert128, "train_gpt2": gpt_train,
                      "generate": gen, "snapshots": snapshots,
                      "serve_graph": serve_graph, "optimizers": optim,
                      "bad_ids": bad_ids, "train_resnet50": resnet,
                      "vision_zoo": zoo, "nd": nd_phases, "a11": a11,
                      "convert": converted, "dist_train": dist_train,
                      "model_parallel": model_parallel,
                      "tp_compute": tp_compute, "hybridize": hybridize,
                      "symbolic": symbolic, "module_and_data": slice19,
                      "image_and_observability": slice20,
                      "decode_step_graphs": graphs, "quantized": quant,
                      "speculative": spec, "chunked_prefill": chunked,
                      "attention_dense_vs_flash": crossover,
                      "attention_fwd_bwd_dense_vs_flash": train_crossover,
                      "card": card}))
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
