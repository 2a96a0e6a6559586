"""Dummy weights from a seed (``load_format="dummy"``), drawn through one
float32 scratch buffer.

A family's ``init_params`` asks :meth:`DummyDraws.normal` for each random
weight, a tensor of the model's dtype allocated at once, and
:meth:`DummyDraws.draw` then fills them in the order asked from one
``torch.Generator``: each unit (the whole tensor, or each of its matrices)
drawn in float32 into the scratch, scaled there and copied in, so the
values are those of a float32 draw of that unit. The scratch, sized for
the largest unit, is the one temporary: allocated after every weight and
returned to the card as soon as the draw ends, it leaves no hole between
weights. A float32 temporary drawn per unit between the weights'
allocations did: later weights took parts of its freed segments, and the
rest stayed stranded beside them, memory the KV pool is sized without
(0.57 GiB under Qwen3-Next's weights, 1.3 GiB under Llama-3.2-1B's on the
H100).

On the ``meta`` device nothing is drawn: ``init_params(cfg, 0, dtype,
"meta")`` gives a family's parameter shapes and dtypes, in order, without
memory (the checkpoint loader's template, ``models/loader.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import torch


class DummyDraws:
    def __init__(self, seed: int, dtype: torch.dtype, device):
        self.dtype = dtype
        self.device = device
        self.gen = None
        if torch.device(device).type != "meta":
            self.gen = torch.Generator(device=device)
            self.gen.manual_seed(seed)
        self._pending: List[Tuple[torch.Tensor, float, bool]] = []

    def normal(self, shape, scale: float, per_matrix: bool = True
               ) -> torch.Tensor:
        """A weight of ``shape`` that :meth:`draw` fills with standard
        normal values times ``scale``, one draw per trailing matrix (or,
        ``per_matrix`` False, one for the whole tensor)."""
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        self._pending.append((out, scale, per_matrix))
        return out

    def draw(self) -> None:
        """Fill every weight asked for, in order."""
        units = [(m, scale) for out, scale, per_matrix in self._pending
                 for m in (out.view(-1, *out.shape[-2:]) if per_matrix
                           else (out,))]
        self._pending = []
        if not units or self.gen is None:
            return
        scratch = torch.empty(max(m.numel() for m, _ in units),
                              dtype=torch.float32, device=self.device)
        for m, scale in units:
            x = scratch[:m.numel()].view(m.shape)
            torch.randn(m.shape, generator=self.gen, out=x)
            m.copy_(x.mul_(scale))
        del scratch, x
        if torch.device(self.device).type == "cuda":
            # hand the scratch's segment back at once: a tensor made next
            # (the rope table) would take part of it and strand the rest
            torch.cuda.empty_cache()
