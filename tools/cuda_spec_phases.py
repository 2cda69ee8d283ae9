#!/usr/bin/env python3
"""Only the speculative-decode and chunked-prefill phases of
``chip_smoke.py`` on one NVIDIA card (about 70 s with the build):

    python3 tools/cuda_spec_phases.py [--keep-going]

It builds the kernels, runs ``phase_speculative``,
``phase_chunked_prefill``, the new programs of ``phase_graph``
(``spec_programs_against_eager``, bf16 and int8) and
``phase_speculative_breakdown``, and writes their readings to
``chiprun_out/spec_phases.json``. ``--keep-going`` prints a failed check
and goes on (to read every number of a first run); without it the first
failed check ends the run with exit code 1.
"""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cuda_spec_phases: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    failed = []
    if "--keep-going" in sys.argv[1:]:
        def check(cond, what):
            if not cond:
                print("CHECK FAILED: %s" % what, flush=True)
                failed.append(what)

        cs.check = check
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    try:
        cs.phase_build()
        spec, plains = cs.phase_speculative(dev)
        chunked = cs.phase_chunked_prefill(dev, plains)
        del plains
        model = cs._gpt_model(dev, cs.SEED + 12)
        rng = np.random.RandomState(cs.SEED + 11)
        prompts = [rng.randint(0, cs.GPT_CONFIG["vocab_size"], n).astype(
            np.int32) for n in cs.GRAPH_PROMPTS]
        graphs = {mode or "bf16": cs.spec_programs_against_eager(
            dev, model, mode, prompts) for mode in (None, "int8")}
        breakdown = cs.phase_speculative_breakdown(dev)
    except cs.SmokeFailure as e:
        print("cuda_spec_phases FAILED: %s" % e, file=sys.stderr)
        return 1
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "spec_phases.json"), "w") as f:
        json.dump({"speculative": spec, "chunked_prefill": chunked,
                   "programs": graphs, "breakdown": breakdown,
                   "failed_checks": failed,
                   "device": torch.cuda.get_device_name(0)}, f, default=str)
    print("failed checks: %d; %.1f s" % (len(failed),
                                         time.perf_counter() - t0))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
