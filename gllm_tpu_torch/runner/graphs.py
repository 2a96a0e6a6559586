"""Compiled steps: one CUDA graph per shape signature (counterpart of
``gllm_tpu/runner/runner.py``: the jit of ``_build_step_fn:650``,
``_note_dispatch:952``, ``warmup:1849``, ``num_shape_signatures:1949``).

The JAX package never runs a step eagerly: each shape signature compiles
once, at first sight or in ``warmup``, and every later step of it runs the
compiled program. Here a step's whole body (forward, logits, sampling) is
captured into a ``torch.cuda.CUDAGraph`` per key:
``BatchBuilder.shape_signature`` (T bucket, S bucket, max_q_len, page
bucket) plus the sampler's static flag all_greedy, as JAX keys its
programs. A pure-decode step's key is that tuple; a mixed step's (a
prefill chunk, a mix of chunks and decode rows, an absorb) is tagged
"mixed", and a host-driven verify step's "verify", with its width
spec_k + 1 and whether a drafted row samples (JAX's ``spec_aux``). A step
whose batch carries extras takes the kind's "_extras" key, which adds
JAX's static extras flags: the logits adjusted (penalties or logit_bias),
logprobs, prompt logprobs (``ModelRunner.step_async``); its logprobs are
graph-owned outputs beside the tokens. Each later step of the key copies
its batch into the views the graph was captured on (``HostStaging``'s
one device buffer) and replays it: one launch for some nine hundred to
three thousand kernels. A hybrid model's mixed steps run eagerly (the
runner counts them).

- The body reads only those views, the runner's parameters and caches, and
  the split-KV scratch, which is sized for every shape before the first
  capture and then held at its address (``pin_decode_scratch``). Its
  sampled tokens land in a tensor the graph owns, which ``run`` copies
  out. All graphs of a runner share one memory pool: replays are ordered
  on one stream, so they never overlap, even with steps in flight.
- Before each capture the body runs once, eagerly, on a side stream, over
  padding rows only (they write the dummy page and SSM slot 0), with a
  throwaway generator: every kernel library and module is loaded and every
  ``cudaFuncSetAttribute`` has run before the stream captures.
- The sampled body draws from the runner's own generator, registered with
  the graph: a replay advances its Philox offset by what the eager step
  would, and reads the same offset, so sampled streams match the eager
  ones under the same seed.
- The kernel wrappers count launches on the host, which a replay does not
  visit; each key records what its capture counted and every replay adds
  that, so the counters keep counting kernel launches.
- A block (``ModelRunner.step_multi``: K chained decode steps) is one
  graph of K sub-steps, keyed by the signature, K, all_greedy, on-device
  finish and the stop-set width E. Under on-device finish sub-steps 1..K-1
  are each captured inside a conditional (IF) node on a device flag (some
  row still alive), so a replay runs only the sub-steps until every row
  has finished: the design, with no fallback to a fixed trip.
  ``if_node`` builds the node with the CUDA runtime's graph API
  (``csrc/graph_cond.cu``: a kernel that sets the node's handle from the
  flag, the IF node after it, and the body captured from a stream of its
  own, one a nesting depth), since the torch this runs on has no binding
  for conditional nodes. The body's allocations go to a second pool of
  the runner, held while its graphs live. A block's launches are counted
  per executed sub-step when the block is collected (``add_substeps``),
  not at replay.
- The sampled mask's fast path (``ops/sampling.topk_topp_mask``, JAX's
  ``lax.cond``) is two IF nodes, over the device flag "every row proved"
  and its complement: the bounded top-k branch and the full-vocab sort
  (``select``); inside a block's sub-step they nest in its IF node.
- No fallback: a capture or replay error raises.

On the CPU there is no graph: ``run`` records the key and runs the same
static-buffer body directly, so the CPU tests cover the staging and the
signature cache.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import time
import weakref
from typing import (Callable, Dict, Hashable, NamedTuple, Optional,
                    Tuple)

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain, pin_decode_scratch,
    release_decode_scratch)
from gllm_tpu_torch.ops.cuda.gdn_scan import (gdn_chunk_scan,
                                              gdn_chunk_scan_plain)
from gllm_tpu_torch.ops.cuda.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)
from gllm_tpu_torch.ops.cuda.threefry import seeded_noise
from gllm_tpu_torch.ops.threefry import seeded_noise_

_WRAPPERS = (ragged_paged_attention, paged_decode_attention, gdn_chunk_scan,
             seeded_noise)
_PLAINS = (ragged_paged_attention_plain, paged_decode_attention_plain,
           gdn_chunk_scan_plain, seeded_noise_)


def launch_counts() -> Dict[Tuple, int]:
    """Every kernel wrapper's launch counters and every plain version's
    call count, keyed (function, counter name or None)."""
    counts = {(fn, k): n for fn in _WRAPPERS for k, n in fn.launches.items()}
    counts.update({(fn, None): fn.calls for fn in _PLAINS})
    return counts


def set_launch_counts(counts: Dict[Tuple, int]) -> None:
    for (fn, k), n in counts.items():
        if k is None:
            fn.calls = n
        else:
            fn.launches[k] = n


def add_launch_counts(delta: Dict[Tuple, int]) -> None:
    for (fn, k), n in delta.items():
        if k is None:
            fn.calls += n
        else:
            fn.launches[k] += n


def pow2_range(lo: int, hi: int) -> Tuple[int, ...]:
    """lo, 2 lo, 4 lo, ... below hi, then hi (``warmup``'s helper)."""
    out, b = [], lo
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return tuple(out)


def warmup_combos(max_decode_seqs: int, max_pages_per_seq: int,
                  num_pages: int, decode_buckets=None, page_buckets=None):
    """The (sequences, pages) of the decode steps ``warmup`` runs, as the
    JAX runner computes them (``runner.py:1863-1880``): every sequence
    bucket at the largest page bucket, and the largest sequence bucket at
    every other page bucket."""
    if decode_buckets is None:
        decode_buckets = pow2_range(8, max_decode_seqs)
    if page_buckets is None:
        page_buckets = pow2_range(4, min(max_pages_per_seq, num_pages - 1))
    combos = [(s, page_buckets[-1]) for s in decode_buckets]
    combos += [(decode_buckets[-1], p) for p in page_buckets[:-1]]
    return combos


_side_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream every warm-up run on ``device`` takes: cuBLAS keeps
    a workspace for each stream it has run on, for the process's life."""
    if device not in _side_streams:
        _side_streams[device] = torch.cuda.Stream(device)
    return _side_streams[device]


KINDS = ("decode", "mixed", "verify", "block", "spec", "decode_extras",
         "mixed_extras", "verify_extras")


def key_kind(key: Hashable) -> str:
    """The kind of step a key captures: a pure-decode step's key is the
    bare signature, every other kind's starts with its name (a step with
    extras: "decode_extras", "mixed_extras", "verify_extras")."""
    return key[0] if isinstance(key[0], str) else "decode"


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor                 # the sampled tokens, graph-owned
    # the logprobs by name (graph-owned), for a body that returns
    # (tokens, aux); None for one that returns the tokens alone
    aux: Optional[dict]
    # launch counts of one replay, or of one sub-step of a block
    delta: Dict[Tuple, int]
    substeps: int                     # a block's K; 0 for one step


class DecodeGraphs:
    """The captured steps of one runner, by key."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 scratch_floats: int):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generator = generator
        self.scratch_floats = scratch_floats
        self.cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        # the IF-node bodies' pool and their streams, one a nesting depth
        # (made at the first IF node)
        self.cond_pool = None
        self._bodies = []
        self._depth = 0
        # the branch flags of the capture under way, held to its end
        self._held = []
        if self.cuda:
            # the split-KV scratch and the capture streams' cuBLAS
            # workspaces go when the last graph holder of the card does
            weakref.finalize(self, release_decode_scratch, self.device)
        self.scratch = None
        self._graphs: Dict[Hashable, _Graph] = {}
        self.keys = set()
        # by kind (``KINDS``): steps served by the signature cache (on the
        # CPU: body runs), keys captured (on the CPU: met), their capture
        # seconds and the bytes the pools grew by in them
        self.by_kind = {k: dict(replays=0, captured=0, capture_s=0.0,
                                pool_bytes=0) for k in KINDS}

    @property
    def replays(self) -> int:
        """Steps served by the signature cache, of every kind."""
        return sum(v["replays"] for v in self.by_kind.values())

    @property
    def capture_seconds(self) -> float:
        """Seconds spent capturing, warm-up runs included."""
        return sum(v["capture_s"] for v in self.by_kind.values())

    def __len__(self) -> int:
        """Distinct signatures captured (on the CPU: met)."""
        return len(self.keys)

    def __contains__(self, key) -> bool:
        return key in self.keys

    def capture(self, key: Hashable, body: Callable[..., torch.Tensor],
                sampled: bool, substeps: int = 0) -> None:
        """Capture ``body(generator, graph)`` → tokens, or (tokens, aux),
        under ``key`` (CUDA only; ``graph`` is the graph being captured,
        for a block's conditional nodes, and None in the warm-up run;
        ``aux`` a dict of tuples of tensors). ``body`` must
        read only buffers that keep their address; the caller has staged
        padding rows in them. ``sampled``: the body draws from the
        generator. ``substeps``: a block's K, whose launch counts are kept
        per sub-step."""
        t0 = time.monotonic()
        if self.scratch is None:
            self.scratch = pin_decode_scratch(self.device,
                                              self.scratch_floats, self)
        counts = launch_counts()
        side = _side_stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            body(torch.Generator(device=self.device))
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph()
        if sampled:
            graph.register_generator_state(self.generator)
        # no garbage collection inside the capture: a collection there can
        # free an engine dropped earlier in a reference cycle, whose graphs'
        # destruction global capture mode forbids (the capture is then
        # invalidated and its next cuBLAS call fails)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, pool=self.pool):
                # inside: entering the capture empties the allocator's
                # cache, so only the segments the capture makes count
                reserved = torch.cuda.memory_reserved(self.device)
                out = body(self.generator, graph)
        finally:
            self._held.clear()
            if collecting:
                gc.enable()
        aux = None
        if isinstance(out, tuple):
            out, aux = out
        stats = self.by_kind[key_kind(key)]
        stats["pool_bytes"] += (torch.cuda.memory_reserved(self.device)
                                - reserved)
        delta = {k: n - before[k] for k, n in launch_counts().items()
                 if n != before[k]}
        if substeps:
            assert all(n % substeps == 0 for n in delta.values()), delta
            delta = {k: n // substeps for k, n in delta.items()}
        set_launch_counts(counts)
        self._graphs[key] = _Graph(graph, out, aux, delta, substeps)
        self.keys.add(key)
        stats["captured"] += 1
        stats["capture_s"] += time.monotonic() - t0

    def run(self, key: Hashable, body: Callable[..., torch.Tensor]):
        """The step's sampled tokens (with its logprobs where the body
        returns (tokens, aux)): on CUDA, ``key``'s graph replayed
        (captured first by the caller) and its tokens copied, since the
        key's next replay overwrites them while they may still be read (a
        step chained off them, their copy to the host); its logprobs are
        the graph's own, which the caller copies to the host before the
        next replay; on the CPU, ``body`` run."""
        stats = self.by_kind[key_kind(key)]
        stats["replays"] += 1
        if not self.cuda:
            if key not in self.keys:
                self.keys.add(key)
                stats["captured"] += 1
            return body(self.generator)
        g = self._graphs[key]
        g.graph.replay()
        if not g.substeps:
            add_launch_counts(g.delta)
        out = g.out.clone()
        return out if g.aux is None else (out, g.aux)

    def add_substeps(self, key: Hashable, k_exec: int) -> None:
        """Count the launches of a collected block's ``k_exec`` executed
        sub-steps (on the CPU its body counted them as it ran)."""
        if self.cuda:
            add_launch_counts({k: n * k_exec
                               for k, n in self._graphs[key].delta.items()})

    def body_stream(self, depth: int = 0) -> torch.cuda.ExternalStream:
        """The stream the IF-node bodies at nesting ``depth`` are captured
        from (an IF node inside a body is captured from the next one; a
        block's warm-up runs its sub-steps 1.. on depth 0's, so that the
        libraries make their per-stream workspaces for it outside any
        capture): a stream of its own, made with the CUDA runtime (torch's
        pooled streams may alias the capture stream)."""
        while len(self._bodies) <= depth:
            handle = ctypes.c_void_p()
            build.check(build.kernel("graph_cond")(
                2, None, None, ctypes.addressof(handle)), "body stream")
            self._bodies.append(torch.cuda.ExternalStream(
                handle.value, device=self.device))
        if self.cond_pool is None:
            # the bodies' allocations: a pool held while the graphs live
            self.cond_pool = torch.cuda.graph_pool_handle()
            idx = self.device.index
            torch._C._cuda_beginAllocateCurrentThreadToPool(idx,
                                                            self.cond_pool)
            torch._C._cuda_endAllocateToPool(idx, self.cond_pool)
            weakref.finalize(self, torch._C._cuda_releasePool, idx,
                             self.cond_pool)
        return self._bodies[depth]

    @contextlib.contextmanager
    def if_node(self, flag: torch.Tensor):
        """Under capture on the current stream: what the caller puts on
        the current stream is captured into an IF node, which a replay
        runs only when the device bool ``flag`` (one element) is true
        then. Inside an IF node's body, the node nests in it."""
        capture = torch.cuda.current_stream(self.device)
        body = self.body_stream(self._depth)
        build.check(build.kernel("graph_cond")(
            0, capture.cuda_stream, flag.data_ptr(), body.cuda_stream),
            "IF node")
        idx = self.device.index
        # the outermost node routes this thread's allocations to the
        # bodies' pool; a nested one is inside that already
        outer = self._depth == 0
        self._depth += 1
        try:
            if outer:
                torch._C._cuda_beginAllocateCurrentThreadToPool(
                    idx, self.cond_pool)
            try:
                with torch.cuda.stream(body):
                    yield
            finally:
                if outer:
                    torch._C._cuda_endAllocateToPool(idx, self.cond_pool)
                    torch._C._cuda_releasePool(idx, self.cond_pool)
        finally:
            # the body's capture ends whatever happened inside it
            self._depth -= 1
            build.check(build.kernel("graph_cond")(
                1, None, None, body.cuda_stream), "IF node body")

    def select(self, flag: torch.Tensor, fast, slow) -> torch.Tensor:
        """A branch on the device bool ``flag`` inside a captured body
        (the sampled mask's fast path, ``ops/sampling.topk_topp_mask``;
        JAX's ``lax.cond``): under capture, ``fast()`` in an IF node on
        ``flag`` and ``slow()`` in one on its complement, which writes
        its result over the fast branch's output (allocated in the
        first node whether or not it runs), so a replay runs one branch
        and no host reads the flag. Uncaptured (the warm-up run before a capture)
        both branches run, so that each has run once outside it, and the
        bodies' streams the capture will take are made."""
        if not torch.cuda.is_current_stream_capturing():
            self.body_stream(self._depth + 1)
            return torch.where(flag, fast(), slow())
        other = ~flag
        self._held += [flag, other]
        with self.if_node(flag):
            out = fast()
        # the fast branch's output, written by the other when it runs
        with self.if_node(other):
            out.copy_(slow())
        return out

    @contextlib.contextmanager
    def on_body_stream(self):
        """Uncaptured (a block's warm-up run): the block's work on the
        bodies' stream, ordered after and before the current stream's."""
        current = torch.cuda.current_stream(self.device)
        body = self.body_stream()
        body.wait_stream(current)
        try:
            with torch.cuda.stream(body):
                yield
        finally:
            current.wait_stream(body)

    def pool_bytes(self) -> int:
        """Device bytes the graphs' memory pools hold."""
        if self.pool is None:
            return 0
        pools = {self.pool, self.cond_pool}
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) in pools)
