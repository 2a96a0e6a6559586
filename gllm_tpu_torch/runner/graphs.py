"""Compiled decode steps: one CUDA graph per decode shape signature
(counterpart of ``gllm_tpu/runner/runner.py``: the jit of
``_build_step_fn:650``, ``_note_dispatch:952``, ``warmup:1849``,
``num_shape_signatures:1949``).

The JAX package never runs a step eagerly: each shape signature compiles
once, at first sight or in ``warmup``, and every later step of it runs the
compiled program. Here a pure-decode step's whole body (forward, logits,
sampling) is captured into a ``torch.cuda.CUDAGraph`` per key (T bucket,
S bucket, max_q_len, page bucket, all_greedy): ``BatchBuilder.shape_signature``
plus the sampler's static flag, as JAX keys its programs. Each later step of
the key copies its batch into the views the graph was captured on
(``HostStaging``'s one device buffer) and replays it: one launch for some
nine hundred to three thousand kernels.

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
  own), since the torch this runs on has no binding for conditional
  nodes. The body's allocations go to a second pool of the runner, held
  while its graphs live. A block's launches are counted per executed
  sub-step when the block is collected (``add_substeps``), not at
  replay.
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
from typing import Callable, Dict, Hashable, NamedTuple, Tuple

import torch

from gllm_tpu_torch.ops.cuda import build
from gllm_tpu_torch.ops.cuda.decode_attention import (
    paged_decode_attention, paged_decode_attention_plain, pin_decode_scratch,
    release_decode_scratch)
from gllm_tpu_torch.ops.cuda.gdn_scan import (gdn_chunk_scan,
                                              gdn_chunk_scan_plain)
from gllm_tpu_torch.ops.cuda.ragged_attention import (
    ragged_paged_attention, ragged_paged_attention_plain)

_WRAPPERS = (ragged_paged_attention, paged_decode_attention, gdn_chunk_scan)
_PLAINS = (ragged_paged_attention_plain, paged_decode_attention_plain,
           gdn_chunk_scan_plain)


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


class _Graph(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: torch.Tensor                 # the sampled tokens, graph-owned
    # launch counts of one replay, or of one sub-step of a block
    delta: Dict[Tuple, int]
    substeps: int                     # a block's K; 0 for one step


class DecodeGraphs:
    """The captured decode steps of one runner, by key."""

    def __init__(self, device: torch.device, generator: torch.Generator,
                 scratch_floats: int):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.generator = generator
        self.scratch_floats = scratch_floats
        self.cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.cuda else None
        # the IF-node bodies' pool and stream (made at the first block)
        self.cond_pool = None
        self._body = None
        if self.cuda:
            # the split-KV scratch and the capture streams' cuBLAS
            # workspaces go when the last graph holder of the card does
            weakref.finalize(self, release_decode_scratch, self.device)
        self.scratch = None
        self._graphs: Dict[Hashable, _Graph] = {}
        self.keys = set()
        self.capture_seconds = 0.0
        # decode steps served by the signature cache (on the CPU: body runs)
        self.replays = 0

    def __len__(self) -> int:
        """Distinct signatures captured (on the CPU: met)."""
        return len(self.keys)

    def __contains__(self, key) -> bool:
        return key in self.keys

    def capture(self, key: Hashable, body: Callable[..., torch.Tensor],
                sampled: bool, substeps: int = 0) -> None:
        """Capture ``body(generator, graph)`` → tokens under ``key`` (CUDA
        only; ``graph`` is the graph being captured, for a block's
        conditional nodes, and None in the warm-up run). ``body`` must
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
                out = body(self.generator, graph)
        finally:
            if collecting:
                gc.enable()
        delta = {k: n - before[k] for k, n in launch_counts().items()
                 if n != before[k]}
        if substeps:
            assert all(n % substeps == 0 for n in delta.values()), delta
            delta = {k: n // substeps for k, n in delta.items()}
        set_launch_counts(counts)
        self._graphs[key] = _Graph(graph, out, delta, substeps)
        self.keys.add(key)
        self.capture_seconds += time.monotonic() - t0

    def run(self, key: Hashable,
            body: Callable[..., torch.Tensor]) -> torch.Tensor:
        """The step's sampled tokens: on CUDA, ``key``'s graph replayed
        (captured first by the caller) and its output copied, since the
        key's next replay overwrites it while the tokens may still be
        read (a step chained off them, their copy to the host); on the
        CPU, ``body`` run."""
        self.replays += 1
        if not self.cuda:
            self.keys.add(key)
            return body(self.generator)
        g = self._graphs[key]
        g.graph.replay()
        if not g.substeps:
            add_launch_counts(g.delta)
        return g.out.clone()

    def add_substeps(self, key: Hashable, k_exec: int) -> None:
        """Count the launches of a collected block's ``k_exec`` executed
        sub-steps (on the CPU its body counted them as it ran)."""
        if self.cuda:
            add_launch_counts({k: n * k_exec
                               for k, n in self._graphs[key].delta.items()})

    def body_stream(self) -> torch.cuda.ExternalStream:
        """The stream the IF-node bodies are captured from (and a block's
        warm-up runs its sub-steps 1.. on, so that the libraries make
        their per-stream workspaces for it outside any capture): a stream
        of its own, made with the CUDA runtime (torch's pooled streams may
        alias the capture stream)."""
        if self._body is None:
            handle = ctypes.c_void_p()
            build.check(build.kernel("graph_cond")(
                2, None, None, ctypes.addressof(handle)), "body stream")
            self._body = torch.cuda.ExternalStream(handle.value,
                                                   device=self.device)
            # the bodies' allocations: a pool held while the graphs live
            self.cond_pool = torch.cuda.graph_pool_handle()
            idx = self.device.index
            torch._C._cuda_beginAllocateCurrentThreadToPool(idx,
                                                            self.cond_pool)
            torch._C._cuda_endAllocateToPool(idx, self.cond_pool)
            weakref.finalize(self, torch._C._cuda_releasePool, idx,
                             self.cond_pool)
        return self._body

    @contextlib.contextmanager
    def if_node(self, flag: torch.Tensor):
        """Under capture on the current stream: what the block puts on the
        current stream is captured into an IF node, which a replay runs
        only when the device bool ``flag`` (one element) is true then."""
        capture = torch.cuda.current_stream(self.device)
        body = self.body_stream()
        build.check(build.kernel("graph_cond")(
            0, capture.cuda_stream, flag.data_ptr(), body.cuda_stream),
            "IF node")
        idx = self.device.index
        torch._C._cuda_beginAllocateCurrentThreadToPool(idx, self.cond_pool)
        try:
            with torch.cuda.stream(body):
                yield
        finally:
            torch._C._cuda_endAllocateToPool(idx, self.cond_pool)
            torch._C._cuda_releasePool(idx, self.cond_pool)
            build.check(build.kernel("graph_cond")(
                1, None, None, body.cuda_stream), "IF node body")

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
