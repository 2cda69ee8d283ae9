"""One replayable program per step key (counterpart of the JAX package's
one compiled program per decode-loop key, ``mxnet_tpu/serve/decoder.py``
``_decode_fns``, ``_verify_fns`` and ``_chunk_fns``).

``GenerativeServer`` runs every step of its decode loop through
:class:`StepPrograms`. A key is a kind and its shape:

- ``("decode", capacity, sampling)``: the decode step of every slot;
- ``("verify", capacity, spec_k, sampling)``: the speculative verify step,
  a window of ``spec_k`` rows a slot;
- ``("chunk", tc, capacity, sampling)``: one chunk of ``tc`` prompt
  positions of a chunked prefill, into the page of a slot the program
  reads from a device buffer (so one program serves every slot).

The greedy and the sampled step are two programs, since the sampler's host
branch (``sample_tokens``'s ``sampling`` flag) cannot live inside one
graph. (Whether the server is quantized is fixed for its life, so it is no
part of the key.) A ``ModelDraft`` runs its k-step draft round through a
:class:`StepPrograms` of its own, keyed ``("draft", capacity)``. On a CUDA
device each key is one ``torch.cuda.CUDAGraph``, captured at its first use
and replayed at every step after; on the CPU the same object runs the step
eagerly, with the same keys, counts and buffer checks, so they can be
tested there.

A step reads and writes static buffers only: the caller hands
:meth:`StepPrograms.run` the step's state (a dict of named tensors or
lists of tensors: its input tokens, ``valid``, the sampling controls, the
K/V pages and their scales, the drafts, the output buffers) and the
model's parameters, and the step updates them in place (the next tokens
into the token buffer, ``valid += active``). Host values a step needs (the
n-gram drafts, a chunk's tokens and slot) are copied into such a buffer
before the run, never handed over as new tensors. A graph is valid only
while those buffers are the tensors it was captured on, so every run
compares the address of each named buffer with the one last seen under
that name, whatever the key; a capacity migration (new page tensors) or a
parameter that was given a new tensor drops every program, and each key
is captured again at its next use. A weight swap that copies into the live
parameters keeps them.

Capture, the address check and the launch counts are the shared
module's (``mxnet_tpu_torch/capture.py``): the warm-up runs on clones of
the state (the live buffers are only read, and capture itself executes
nothing), so a capture in the middle of serving leaves every live stream
as it was, and the first replay after it is the step that stream would
have taken; a replay adds back the launches its capture counted, so a
step counts its kernels exactly as an eager step does.

Memory. All graphs of one :class:`StepPrograms` share one memory pool (a
new one after a drop); they never replay concurrently, and a program's
output (the logits) is read only before the next replay of any program:
the caller runs :meth:`StepPrograms.run` under its one dispatch lock (the
server's ``_params_lock``), which is also what serialises the programs'
bookkeeping.
"""
from __future__ import annotations

import torch

from .. import engine
from ..observability import costs
from ..capture import (AddressBook, Graph, capture_counter,  # noqa: F401
                       capture_graph, clone_state, collector_paused)

__all__ = ["StepPrograms", "capture_counter"]


def _addresses(state, params):
    """{buffer name: its address} of a state dict and the parameters."""
    out = {}
    for name, value in state.items():
        if isinstance(value, torch.Tensor):
            out[name] = value.data_ptr()
        else:
            out.update(((name, i), t.data_ptr()) for i, t in enumerate(value))
    out.update((("params", i), t.data_ptr()) for i, t in enumerate(params))
    return out


class StepPrograms:
    """The step programs of one server (or of its draft), keyed.

    ``captures`` counts programs made (captured on CUDA, set up on the
    CPU), ``replays`` steps run through a program, ``drops`` the times the
    buffers moved and every program was dropped."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self._programs = {}
        self._addresses = AddressBook()
        self._pool = None
        self.captures = 0
        self.replays = 0
        self.drops = 0

    def keys(self):
        return list(self._programs)

    def run(self, key, body, state, params=(), eager=False):
        """One step: ``body(state)`` (which returns the logits) through the
        program of ``key``, or eagerly when ``eager``. ``params`` are the
        tensors the step reads besides ``state`` (the weights): their
        addresses join the buffers' check. Returns the logits, which a
        graph's next replay overwrites."""
        if eager:
            return body(state)
        if self._addresses.moved(_addresses(state, params)) and \
                self._programs:
            # the pool goes with the last graph that used it: the next
            # capture takes a new one
            self._programs.clear()
            self._pool = None
            self.drops += 1
        prog = self._programs.get(key)
        first = None
        if prog is None:
            note = "decode[%s]" % (key,)
            m = costs.meter("decode_capture", note, self.device)
            if self.graphed:
                prog = self._capture(body, state, m)
            else:
                prog, first = Graph(), m
            self._programs[key] = prog
            self.captures += 1
            capture_counter.count += 1
            engine.decode_capture_counter.bump(note=note)
        self.replays += 1
        if prog.graph is None:
            return costs.run_counted(first, lambda: body(state))
        return prog.replay()

    def _capture(self, body, state, meter=None):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        scratch = clone_state(state)
        # thread_local: the server's other threads (admission, readers) do
        # host work while the step thread captures
        return capture_graph(lambda: body(state), self.device, self._pool,
                             warmup=lambda: body(scratch), meter=meter)
