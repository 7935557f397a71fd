"""Operation counts of one call, taken on meta tensors (the port's
counterpart of ``repro.analysis.hlo_parse``).

The reference parses the compiled HLO of a step.  The port has no HLO: it
runs the step once on meta tensors (shapes and dtypes, no memory, no
arithmetic) under a ``TorchDispatchMode`` and counts every ATen operation
the call dispatches, with the reference's rules:

* FLOPs: 2·M·N·K for each matmul-class op (``mm``, ``addmm``, ``bmm``,
  ``baddbmm``; the SDPA ops and convolutions, forward and backward, by
  ``torch.utils.flop_counter``'s formulas, which apply the same rule to
  each product), as ``_dot_flops`` counts a ``dot``;
* traffic: operand and result bytes of those ops (as for a ``dot``), the
  result bytes of every other op but views, which move nothing.  Like the
  reference's, this is an upper bound: no reuse across operations.

Python loops run as they would on the card, so a layer stack is counted
layer by layer (the reference scales while bodies by their trip count).
``collective_bytes`` stays empty here: one process dispatches no
collective for a sharded step; ``analysis.roofline`` adds the collectives
the argument shardings imply.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

aten = torch.ops.aten

_MATMUL = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# matmul-class ops counted by torch.utils.flop_counter's formulas
_REGISTERED = ("_scaled_dot_product_efficient_attention",
               "_scaled_dot_product_flash_attention",
               "_scaled_dot_product_cudnn_attention",
               "_scaled_dot_product_efficient_attention_backward",
               "_scaled_dot_product_flash_attention_backward",
               "_scaled_dot_product_cudnn_attention_backward",
               "_flash_attention_forward", "_flash_attention_backward",
               "_efficient_attention_forward", "_efficient_attention_backward",
               "convolution", "_convolution", "convolution_backward")


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> float:
    """2·M·N·K of an (add)mm or (bad)bmm: the product's output elements
    times twice its contracted size."""
    if func in (aten.addmm, aten.baddbmm):
        a, b = args[1], args[2]
    else:
        a, b = args[0], args[1]
    return 2.0 * math.prod(a.shape) * b.shape[-1]


@dataclass
class Costs:
    flops: float = 0.0
    traffic_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(default_factory=dict)
    # op name → [calls, FLOPs, bytes]
    table: Dict[str, list] = field(default_factory=dict)

    def total_collective(self) -> float:
        return sum(self.collective_bytes.values())

    def scaled(self, div: float) -> "Costs":
        """Every figure divided by ``div`` (one device's share)."""
        return Costs(self.flops / div, self.traffic_bytes / div,
                     {k: v / div for k, v in self.collective_bytes.items()},
                     {k: [n, f / div, b / div]
                      for k, (n, f, b) in self.table.items()})


class _CountMode(TorchDispatchMode):
    def __init__(self, costs: Costs):
        super().__init__()
        self.costs = costs
        from torch.utils.flop_counter import flop_registry
        self.registered = {}
        for name in _REGISTERED:
            packet = getattr(aten, name, None)
            if packet is not None and packet in flop_registry:
                self.registered[packet] = flop_registry[packet]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        flops = 0.0
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if packet in _MATMUL or packet in self.registered:
            if packet in _MATMUL:
                flops = _matmul_flops(packet, args)
            else:
                flops = float(self.registered[packet](*args, **kwargs,
                                                      out_val=out))
            ins = [t for t in tree_flatten((args, kwargs))[0]
                   if isinstance(t, torch.Tensor)]
            nbytes = sum(tensor_bytes(t) for t in ins + outs)
        elif func.is_view or packet in (aten.detach, aten.lift_fresh,
                                        aten._unsafe_view):
            nbytes = 0
        else:
            nbytes = sum(tensor_bytes(t) for t in outs)
        c = self.costs
        c.flops += flops
        c.traffic_bytes += nbytes
        row = c.table.setdefault(str(packet), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out


def count_costs(fn, *args, **kwargs) -> Tuple[object, Costs]:
    """``fn(*args, **kwargs)`` run once under the counting mode: (its
    result, the ``Costs`` of every operation it dispatched).  Give it meta
    tensors to count a full-size call with no memory and no arithmetic."""
    costs = Costs()
    with _CountMode(costs):
        out = fn(*args, **kwargs)
    return out, costs
