#!/usr/bin/env python3
"""Some of ``chip_smoke.py``'s phases alone on one NVIDIA card, to read
their numbers without the whole run:

    python3 tools/cuda_phases.py [--keep-going] GROUP...

Each GROUP runs these phases of ``chip_smoke.py``, after the kernels are
built:

- ``kernels``: every kernel against its plain version (``phase_layernorm``,
  ``phase_flash``, ``phase_flash_f32``, ``phase_xent``, ``phase_flash_bwd``);
- ``spec``: ``phase_speculative``, ``phase_chunked_prefill``, the
  speculative programs of ``phase_graph`` (bf16 and int8) and
  ``phase_speculative_breakdown``;
- ``gpt_train``: ``phase_gpt_train``, ``phase_gpt_train_timing`` and the
  step's torch.profiler breakdown;
- ``snapshot``: ``phase_snapshot``;
- ``serve_graph``: ``phase_serve`` and ``phase_serve_graph`` (bf16), then
  ``phase_serve_quant`` and ``phase_serve_graph`` (int8): the ModelServer's
  graph per bucket, a weight swap in a burst, a bucket retune; and
  ``phase_bad_ids`` (ids outside the table beside a good stream);
- ``optim``: ``phase_optimizers`` (the fifteen optimizers over GPT-2
  small's parameters against the CPU), ``phase_gpt_train_optimizers``
  (SGD with a cosine schedule and LAMB) and their steps' breakdowns;
- ``vision``: ``phase_resnet_train`` (ResNet-50 at bench.py's recipe),
  ``phase_resnet_timing`` (the softmax-xent kernels at its (128, 1000)
  logits), ``phase_resnet_serve`` (bf16 and int8 ModelServers),
  ``phase_vision_zoo`` (the other families against the CPU) and the
  ResNet-50 step's breakdown;
- ``nd``: ``phase_nd_train`` (GPT-2 small in MXNet's imperative idiom
  beside the tensor path), ``phase_nd_ops`` (every ``nd`` op on the card
  against the CPU; the kernel-backed ``nd`` ops' launches) and
  ``phase_create_graph`` (second order on the card);
- ``a11``: ``phase_lstm_train``, ``phase_lstm_infer``,
  ``phase_ssd_train``, ``phase_ssd_detect``, ``phase_nmt_train`` and
  ``phase_nmt_translate`` (LSTM PTB, SSD-512 and Transformer NMT at
  bench.py's recipes), ``phase_a11_timing`` (the LayerNorm and
  softmax-xent kernels at their shapes) and the three steps'
  breakdowns;
- ``dist``: ``phase_convert`` (a torchvision ResNet-50 checkpoint
  converted, HF BERT-base and GPT-2 small transplanted and run) and
  ``phase_dist_train`` (the GPT-2 step through ``dist.attach`` over an
  NCCL group of one rank at ZeRO 0-3 and each compression, a planted
  bucket fault, and ``ModelServer(devices=[card, card])``) and
  ``phase_dist_breakdown`` (the attached step under torch.profiler);
- ``tp``: ``phase_tp_compute`` (Megatron compute sharding: GPT-2 small's
  forward and backward at tp = 4 replayed on the card against the unsplit
  step and fp32, BERT-base's MLM head through the vocabulary-parallel
  loss at tp = 2 with a planted merge fault, ``build_train_step``'s split
  path at {dp: 1, tp: 1} against the plain step);
- ``hybridize``: ``phase_hybridize`` (the GPT-2 small step through
  ``hybridize()`` and the Trainer's step program against the eager step);
- ``library_ops``: ``phase_library_ops`` (each kernel as its
  ``torch.library`` op against its plain version, ``opcheck``, eager
  against ``torch.compile`` launches, a planted fake);
- ``bulk``: ``phase_bulk`` (a 15-op ``nd`` chain as one program);
- ``tape_replay``: ``phase_tape_replay`` (the NDArray GPT-2 step with the
  compiled tape replay against the eager walk; GPT-2 through
  ``torch.compile(fullgraph=True)``);
- ``symbol_serve``: ``phase_symbol_serve`` (BERT-base served from its
  export layout through ``serve.load`` and a ``SymbolBlock``);
- ``symbol_train``: ``phase_symbol_train`` (GPT-2 small trained through
  ``simple_bind`` and the captured ``Executor``);
- ``module_fit``: ``phase_module_fit`` (GPT-2 small's loss symbol through
  ``Module.fit`` over a PrefetchingIter, score, predict, the checkpoint
  round trip, a planted stale-weight update);
- ``data_pipeline``: ``phase_data_pipeline`` (the bert128 step fed by the
  DataLoader with pinned memory, ``split_and_load``, ``clip_global_norm``
  with a planted rebinding clip, the process-worker loader);
- ``bucketing_lstm``: ``phase_bucketing_lstm`` (LSTM PTB through
  ``BucketSentenceIter`` and ``BucketingModule``, then
  ``phase_control_flow``: a foreach LSTM, while_loop and cond captured);
- ``get_symbol``: ``phase_get_symbol`` (GPT-2 small's recorded forward
  and loss as a Symbol, bound on the card);
- ``slice19``: the four above in one run (``run_slice19``);
- ``image_probe``: ``phase_image_probe`` (which JPEG decoders the
  machine has: the committed ``libmxtpu_im.so`` and its libjpeg, PIL,
  nvJPEG's header and library; no build);
- ``image_decode``: ``phase_image_decode`` (path (d): each fixture
  record's decode against the JAX package's, a planted chroma swap);
- ``image_record``: ``phase_image_record_resnet`` (path (a): ResNet-50 fed
  by ``ImageRecordIter`` over 1024 repacked records);
- ``image_det``: ``phase_image_det_ssd`` (path (b): SSD-512 fed by
  ``ImageDetRecordIter``);
- ``vision_loader``: ``phase_vision_loader`` (path (c): ResNet-50 fed by
  ``ImageRecordDataset``, the vision transforms and the DataLoader with
  0, 4 thread and 2 process workers);
- ``observability``: ``phase_observability`` (path (e): ``/metrics`` of a
  BERT ModelServer and a GPT-2 GenerativeServer, traces, the watchdog,
  the profiler's trace);
- ``slice20``: the probe and the five above in one run (``run_slice20``);
- ``mp``: ``phase_model_parallel`` (the GPT-2 step inside
  ``sequence_parallel_scope`` at sp = 1, ring and Ulysses, against the
  plain step; the n = 4 ring replayed on the card against the
  whole-sequence flash kernel, with a planted merge fault; the
  ``param_spec`` train step at tp = 1, ``moe_ffn`` at ep = 1, 1F1B at
  pp = 1 and ``SyncBatchNorm`` at dp = 1 against their plain forms).

The readings go to ``chiprun_out/cuda_phases.json``. ``--keep-going``
prints a failed check and goes on (to read every number of a first run);
without it the first failed check ends the run with exit code 1.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "chiprun_out", "cuda_phases.json")
GPT_KERNELS = ("layernorm_fwd", "layernorm_bwd", "flash_attention_fwd",
               "flash_attention_bwd", "softmax_xent_fwd", "softmax_xent_bwd")


def run_kernels(cs, dev):
    ln_fwd, ln_bwd = cs.phase_layernorm(dev)
    return {"layernorm": ln_fwd, "layernorm_bwd": ln_bwd,
            "flash_attention_fwd": cs.phase_flash(dev),
            "flash_attention_fwd_f32": cs.phase_flash_f32(dev),
            "softmax_xent": cs.phase_xent(dev),
            "flash_attention_bwd": cs.phase_flash_bwd(dev)}


def run_spec(cs, dev):
    import numpy as np

    spec, plains = cs.phase_speculative(dev)
    chunked = cs.phase_chunked_prefill(dev, plains)
    del plains
    model = cs._gpt_model(dev, cs.SEED + 12)
    rng = np.random.RandomState(cs.SEED + 11)
    prompts = [rng.randint(0, cs.GPT_CONFIG["vocab_size"], n).astype(
        np.int32) for n in cs.GRAPH_PROMPTS]
    programs = {mode or "bf16": cs.spec_programs_against_eager(
        dev, model, mode, prompts) for mode in (None, "int8")}
    return {"speculative": spec, "chunked_prefill": chunked,
            "programs": programs,
            "breakdown": cs.phase_speculative_breakdown(dev)}


def run_gpt_train(cs, dev):
    step, out = cs.phase_gpt_train(dev)
    records = [{"name": n} for n in GPT_KERNELS]
    cs.phase_gpt_train_timing(dev, records, out)
    out["kernels"] = records
    out["breakdown"] = cs.phase_train_breakdown(step,
                                                label="gpt2 train step")
    return out


def run_serve_graph(cs, dev):
    out = {}
    srv = cs.phase_serve(dev)[-1]
    out["bf16"] = cs.phase_serve_graph(dev, srv, "bf16 BERT server")
    del srv
    srv = cs.phase_serve_quant(dev)[-1]
    out["int8"] = cs.phase_serve_graph(dev, srv, "int8 BERT server", "int8")
    del srv
    out["bad_ids"] = cs.phase_bad_ids(dev, cs._gpt_model(dev, cs.SEED))
    return out


def run_optim(cs, dev):
    out = {"one_step": cs.phase_optimizers(dev)}
    steps, out["gpt2_steps"] = cs.phase_gpt_train_optimizers(dev)
    for label, step in steps.items():
        out["gpt2_steps"][label]["breakdown"] = cs.phase_train_breakdown(
            step, label="gpt2 train step, %s" % label)
    return out


def run_vision(cs, dev):
    step, out = cs.phase_resnet_train(dev)
    records = [{"name": "softmax_xent_fwd"}, {"name": "softmax_xent_bwd"}]
    cs.phase_resnet_timing(dev, records, out)
    out["kernels"] = records
    out["serving"] = cs.phase_resnet_serve(dev, step.net)
    out["zoo"] = cs.phase_vision_zoo(dev)
    out["breakdown"] = cs.phase_resnet_breakdown(step)
    return out


def run_nd(cs, dev):
    return {"train": cs.phase_nd_train(dev), "ops": cs.phase_nd_ops(dev),
            "create_graph": cs.phase_create_graph(dev)}


def run_a11(cs, dev):
    steps, out = cs.run_a11(dev)
    records = [{"name": n} for n in ("layernorm_fwd", "layernorm_bwd",
                                     "softmax_xent_fwd", "softmax_xent_bwd")]
    cs.phase_a11_timing(dev, records, out["lstm_train"], out["nmt_train"])
    out["kernels"] = records
    cs.a11_breakdowns(steps, out)
    return out


def run_dist(cs, dev):
    out = {"convert": cs.phase_convert(dev),
           "dist_train": cs.phase_dist_train(dev)}
    out["dist_train"]["breakdown"] = cs.phase_dist_breakdown(dev)
    return out


GROUPS = {"kernels": run_kernels, "spec": run_spec,
          "gpt_train": run_gpt_train,
          "snapshot": lambda cs, dev: cs.phase_snapshot(dev),
          "serve_graph": run_serve_graph, "optim": run_optim,
          "vision": run_vision, "nd": run_nd, "a11": run_a11,
          "dist": run_dist,
          "mp": lambda cs, dev: cs.phase_model_parallel(dev),
          "tp": lambda cs, dev: cs.phase_tp_compute(dev),
          "hybridize": lambda cs, dev: cs.phase_hybridize(dev),
          "library_ops": lambda cs, dev: cs.phase_library_ops(dev),
          "bulk": lambda cs, dev: cs.phase_bulk(dev),
          "tape_replay": lambda cs, dev: cs.phase_tape_replay(dev),
          "symbol_serve": lambda cs, dev: cs.phase_symbol_serve(dev),
          "symbol_train": lambda cs, dev: cs.phase_symbol_train(dev),
          "module_fit": lambda cs, dev: cs.phase_module_fit(dev),
          "data_pipeline": lambda cs, dev: cs.phase_data_pipeline(dev),
          "bucketing_lstm": lambda cs, dev: cs.phase_bucketing_lstm(dev),
          "get_symbol": lambda cs, dev: cs.phase_get_symbol(dev),
          "slice19": lambda cs, dev: cs.run_slice19(dev),
          "image_probe": lambda cs, dev: cs.phase_image_probe(),
          "image_decode": lambda cs, dev: cs.phase_image_decode(dev),
          "image_record": lambda cs, dev: cs.phase_image_record_resnet(
              dev)[1],
          "image_det": lambda cs, dev: cs.phase_image_det_ssd(dev),
          "vision_loader": lambda cs, dev: cs.phase_vision_loader(
              dev, cs.ResNetTrainStep(dev)),
          "observability": lambda cs, dev: cs.phase_observability(dev),
          "slice20": lambda cs, dev: cs.run_slice20(dev)}
# groups that need no kernel
NO_BUILD = {"image_probe"}


def main(argv):
    groups = [a for a in argv if a != "--keep-going"]
    if not groups or any(g not in GROUPS for g in groups):
        print("usage: cuda_phases.py [--keep-going] GROUP... (GROUP one of "
              "%s)" % ", ".join(GROUPS), file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("cuda_phases: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    failed = []
    if "--keep-going" in argv:
        def check(cond, what):
            if not cond:
                print("CHECK FAILED: %s" % what, flush=True)
                failed.append(what)

        cs.check = check
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    out = {"device": torch.cuda.get_device_name(0)}
    try:
        if any(g not in NO_BUILD for g in groups):
            cs.phase_build()
        for g in groups:
            out[g] = GROUPS[g](cs, dev)
    except cs.SmokeFailure as e:
        print("cuda_phases FAILED: %s" % e, file=sys.stderr)
        return 1
    out["failed_checks"] = failed
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, default=str)
    print("failed checks: %d; %.1f s" % (len(failed),
                                         time.perf_counter() - t0))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
