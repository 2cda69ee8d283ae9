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
- ``profiler_drift``: ``phase_observability``'s profiler window for 480
  s, in turns under ``mx.profiler`` and under a bare ``torch.profiler``
  session: the windows whose trace lost a LayerNorm or flash event, where
  the names part from a whole window's, each kernel's start against its
  launch call's, the session's margins;
- ``slice20``: the probe and the five above in one run (``run_slice20``);
- ``fleet``: ``phase_fleet`` (two BERT-base workers from a serving
  snapshot and a GPT-2 small worker on the card: a wave, ``kill -9``
  mid-wave, scale-out, ``hot_swap`` and a refused push, ``retire`` with
  prefix migration, the workers' cost sections);
- ``costs``: ``phase_costs`` (BERT-base bucket programs' flops against the
  analytic count, the flash op against SDPA, keys across two processes,
  the planted missing formula, the GPT-2 step's programs);
- ``validate``: ``phase_validate`` (``hybridize(validate=True)`` on
  BERT-base, four planted blocks, the lock check over two servers and a
  planted inversion);
- ``slice21``: the three above in one run (``run_slice21``);
- ``ir``: ``phase_ir`` (the MLP's bf16 math through the bulk window and a
  Symbol.eval: one build; BERT-base's export served through ``ir.lower``;
  the watchdog; a planted cast_sink);
- ``tune``: ``phase_tune`` (``ir.tune.search`` over BERT-base's bucket-8
  program and a fresh process reloading the record, the bulk watermark,
  the fp32 flash split);
- ``comp_cache``: GPT-2 small's compiled step through ``cache.AotFn``
  (phase_tape_replay's) and ``phase_comp_cache`` (a fresh process with an
  empty Inductor cache compiling it from the store, a truncated entry,
  ``runtime.Features()``);
- ``slice22``: the compiled step and the three above (``run_slice22``);
- ``examples``: ``phase_examples`` (the fine-tune twin on BERT-base at
  seq 512 with its launches a step, against the plain versions and a
  planted softmax-xent fault; the PTB LSTM; the long-context ring in a
  group of one; ResNet-50 served through the serve twin);
- ``onnx``: ``phase_onnx`` (BERT-base fp32 exported to ONNX bytes,
  imported on the card and served at bucket 8, against the Gluon model's
  direct forward, with a planted perturbed initializer);
- ``slice23``: the two above (``run_slice23``);
- ``sparse_lm`` or ``slice24``: ``phase_sparse_lm`` (the PTB LSTM LM at
  full widths with a row-sparse ``SparseEmbedding`` trained by
  ``Estimator.fit``: the launches a step, the row-sparse gradient, the
  untouched rows, the lazy update against a dense step with a planted
  dropped row, the plain-version run, the checkpoint; the CSR path
  ``LibSVMIter`` into ``sparse.dot``; the lazy update's time; the
  softmax-xent kernels at the fp32 (1120, 10000) logits, written into the
  two records under ``sparse_lm_train``) through ``run_slice24``;
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
import shutil
import sys
import time

import numpy as np

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


def run_slice22_part(cs, dev, part):
    """Slice 22's phases, alone or together, with the BERT-base export
    and the compiled GPT-2 step they read; the scratch files removed."""
    out = {}
    prefix = None
    try:
        if part in ("comp_cache", "slice22"):
            cold = cs._compiled_gpt_step(dev)
            if part == "slice22":
                return cs.run_slice22(dev, cold)
            return cs.phase_comp_cache(dev, cold)
        prefix, model = cs._bert_export(dev, "ir_bert")
        if part == "ir":
            out = cs.phase_ir(dev, prefix, model)
        else:
            del model
            out = cs.phase_tune(dev, prefix)
    finally:
        if prefix is not None:
            cs._drop_export(prefix)
        for d in cs._slice22_tmp:
            shutil.rmtree(d, ignore_errors=True)
        del cs._slice22_tmp[:]
    return out


def _window_kernels(cs, names, launches, ref):
    """One profiled window's reading: its LayerNorm and flash-forward
    events against the launch counters, and where its kernel names part
    from ``ref`` (a window that lost none)."""
    got = {"layernorm": sum(cs._kernel_class(k) == "layernorm"
                            for k in names),
           "flash": sum(cs._kernel_class(k) == "flash" for k in names)}
    want = {"layernorm": launches.get("layernorm", 0),
            "flash": launches.get("flash_attention_fwd", 0)}
    r = {"kernels": len(names), "events": got, "launches": want,
         "lost": got != want}
    if r["lost"] and ref:
        head = next((i for i, (a, b) in enumerate(zip(names, ref))
                     if a != b), min(len(names), len(ref)))
        r["first_difference"] = head
        r["ref_around"] = ref[max(0, head - 2):head + 6]
        r["got_around"] = names[max(0, head - 2):head + 6]
    return r


def run_profiler_window(cs, dev, seconds=480.0):
    """``phase_observability``'s profiler window, repeated for ``seconds``:
    BERT-base served at ``phase_serve``'s recipe, two batches of 8 in each
    window, in turns under ``mx.profiler`` (form ``mx``) and under a bare
    ``torch.profiler`` session (form ``raw``), whose kineto events give
    each kernel's start against its launch call's (a negative gap is an
    error of the device's clock as the trace reads it), and the margins
    between the session's ends (host clock) and the first kernel's start
    and the last kernel's end."""
    import torch
    from mxnet_tpu_torch import amp, profiler
    from mxnet_tpu_torch.models.bert import bert_base
    from mxnet_tpu_torch.serve import ModelServer

    model = bert_base(dropout=0.1, max_length=cs.SEQ)
    model.initialize(device=dev, generator=torch.Generator(
        device=dev).manual_seed(cs.SEED))
    amp.convert_hybrid_block(model, "bfloat16")
    specs = [((cs.SEQ,), "int32"), ((cs.SEQ,), "int32"), ((), "int32")]
    srv = ModelServer(model, specs, buckets=cs.BUCKETS, max_wait_ms=5.0,
                      timeout_ms=120000.0, device=dev,
                      name="serve:profiler_window")
    rng = np.random.RandomState(cs.SEED + 56)
    n = 16
    vl = rng.randint(1, cs.SEQ + 1, n).astype(np.int32)
    tok = rng.randint(0, cs.VOCAB, (n, cs.SEQ)).astype(np.int32)
    tt = (np.arange(cs.SEQ)[None, :] >= vl[:, None] // 2).astype(np.int32)

    def two_batches():
        for lo, hi in ((0, 8), (8, 16)):
            hs = [srv.submit(tok[i], tt[i], vl[i]) for i in range(lo, hi)]
            for h in hs:
                h.result(timeout_s=300)

    profiler.set_config(filename=os.path.join(
        REPO, "chiprun_out", "profiler_window.json"), aggregate_stats=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    cuda = torch.autograd.DeviceType.CUDA
    rows = {"mx": [], "raw": []}
    ref = None
    t0 = time.perf_counter()
    with srv:
        two_batches()
        i = 0
        while time.perf_counter() - t0 < seconds:
            form = ("mx", "raw")[i % 2]
            i += 1
            cs.reset_counters()
            extra = {}
            if form == "mx":
                profiler.start()
                two_batches()
                profiler.stop()
                trace = json.load(open(profiler.dump()))["traceEvents"]
                profiler.dumps(reset=True)
                names = [e["name"] for e in sorted(
                    trace, key=lambda e: e["ts"]) if e["cat"] == "kernel"]
            else:
                with torch.profiler.profile(activities=acts) as prof:
                    t_in = time.time_ns()
                    two_batches()
                    torch.cuda.synchronize()
                    t_out = time.time_ns()
                evs = prof.profiler.kineto_results.events()
                launch = {e.correlation_id(): e.start_ns() for e in evs
                          if e.device_type() != cuda
                          and e.name() in ("cudaGraphLaunch",
                                           "cudaLaunchKernel",
                                           "cudaLaunchKernelExC",
                                           "cuLaunchKernel")}
                dev_evs = sorted((e for e in evs if e.device_type() == cuda),
                                 key=lambda e: e.start_ns())
                kern = [e for e in dev_evs if "emcpy" not in e.name()
                        and "emset" not in e.name()]
                names = [e.name() for e in kern]
                gaps = [e.start_ns() - launch[e.correlation_id()]
                        for e in kern if e.correlation_id() in launch]
                extra = {
                    "min_gap_us": min(gaps) / 1e3 if gaps else None,
                    "first_margin_us": (dev_evs[0].start_ns() - t_in) / 1e3
                    if dev_evs else None,
                    "last_margin_us": (t_out - max(e.end_ns()
                                                   for e in dev_evs)) / 1e3
                    if dev_evs else None}
            r = _window_kernels(cs, names, cs.read_counters(), ref)
            if not r["lost"] and ref is None:
                ref = names
            r.update(extra, t_s=round(time.perf_counter() - t0, 1))
            rows[form].append(r)
    srv.stop()
    out = {"edge_s": profiler.EDGE_S}
    for form, rs in rows.items():
        lost = [r for r in rs if r["lost"]]
        out[form] = {"windows": len(rs), "lost": len(lost),
                     "lost_rows": lost[:6]}
        if form == "raw":
            for k in ("min_gap_us", "first_margin_us", "last_margin_us"):
                v = [r[k] for r in rs if r[k] is not None]
                out[form][k] = {"min": min(v), "median": float(np.median(v)),
                                "max": max(v)} if v else None
            # the worst gap in each minute: a drift shows as a trend
            by_min = {}
            for r in rs:
                if r["min_gap_us"] is not None:
                    m = int(r["t_s"] // 60)
                    by_min[m] = min(by_min.get(m, 1e18), r["min_gap_us"])
            out[form]["worst_gap_us_by_minute"] = by_min
        print("profiler window %s: %d of %d windows lost kernel events; %s"
              % (form, len(lost), len(rs), out[form]), flush=True)
    return out


def run_dist(cs, dev):
    out = {"convert": cs.phase_convert(dev),
           "dist_train": cs.phase_dist_train(dev)}
    out["dist_train"]["breakdown"] = cs.phase_dist_breakdown(dev)
    return out


def run_slice24(cs, dev):
    """``run_slice24`` with the two softmax-xent kernel records it adds
    its fp32 timings to."""
    records = [{"name": "softmax_xent_fwd"}, {"name": "softmax_xent_bwd"}]
    out = cs.run_slice24(dev, records)
    out["kernel_records"] = records
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
          "profiler_drift": run_profiler_window,
          "slice20": lambda cs, dev: cs.run_slice20(dev),
          "fleet": lambda cs, dev: cs.phase_fleet(dev),
          "costs": lambda cs, dev: cs.phase_costs(dev),
          "validate": lambda cs, dev: cs.phase_validate(dev),
          "slice21": lambda cs, dev: cs.run_slice21(dev),
          "ir": lambda cs, dev: run_slice22_part(cs, dev, "ir"),
          "tune": lambda cs, dev: run_slice22_part(cs, dev, "tune"),
          "comp_cache": lambda cs, dev: run_slice22_part(cs, dev,
                                                         "comp_cache"),
          "slice22": lambda cs, dev: run_slice22_part(cs, dev, "slice22"),
          "examples": lambda cs, dev: cs.phase_examples(dev),
          "onnx": lambda cs, dev: cs.phase_onnx(dev),
          "slice23": lambda cs, dev: cs.run_slice23(dev),
          "sparse_lm": run_slice24, "slice24": run_slice24}
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
