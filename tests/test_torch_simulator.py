"""The port's copy of the calibrated layout simulator
(repro_torch.core.simulator) against the JAX package's: the hardware
envelope, every phase of the paper's workload suite and of a grid of
synthetic phases under every mode and node count, and the oracles built on
them (``simulate``, ``best_mode``, ``best_scope_modes``).  The model is
numpy on the host, so every number is held equal."""
import dataclasses
import itertools

import pytest

from repro.core import simulator as jsim
from repro.core.layouts import LayoutMode as JLayoutMode
from repro.core.workloads import adversarial_workloads, build_workloads
from repro_torch.core import simulator as sim
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy

NODES = (1, 8, 32, 64)


def _port_phase(p: jsim.Phase) -> sim.Phase:
    return sim.Phase(**dataclasses.asdict(p))


def _port_workload(w):
    """A reference workload with its phases as the port's ``Phase``."""
    return type("W", (), {"phases": [_port_phase(p) for p in w.phases],
                          "name": w.test_id})()


def _grid():
    out = []
    for op, topo, pattern, written in itertools.product(
            ("write", "read"), ("NN", "N1"), ("seq", "random", "strided"),
            ("self", "other", "shared")):
        out.append(jsim.Phase("bw", op=op, topology=topo, pattern=pattern,
                              total_mib=4096.0, req_kib=1024.0,
                              written_by=written, cross_rank=0.5))
    for op, rr, written in itertools.product(
            ("write", "read", "mixed"), (0.1, 0.9), ("self", "shared")):
        out.append(jsim.Phase("iops", op=op, read_ratio=rr, req_kib=4,
                              n_ops=20000, written_by=written))
    for dirs, mix in itertools.product(
            ("unique", "shared", "deep"),
            ({"create": 1.0}, {"stat": 0.7, "create": 0.3},
             {"remove": 0.5, "readdir": 0.5})):
        out.append(jsim.Phase("meta", n_ops=50000, dir_pattern=dirs,
                              meta_mix=mix, cross_rank=0.25))
    return out


def test_default_hardware_matches_the_reference():
    assert dataclasses.asdict(sim.DEFAULT_HW) == \
        dataclasses.asdict(jsim.DEFAULT_HW)


@pytest.mark.parametrize("n", NODES)
def test_simulate_phase_grid_matches_the_reference(n):
    """Every grid phase × every mode: the whole ``PhaseResult`` equal."""
    for i, p in enumerate(_grid()):
        for m in LayoutMode:
            got = sim.simulate_phase(_port_phase(p), m, n, seed=i)
            want = jsim.simulate_phase(p, JLayoutMode(int(m)), n, seed=i)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (p, m, n)


@pytest.mark.parametrize("suite", ["paper", "adversarial"])
def test_workload_suite_and_oracles_match_the_reference(suite):
    workloads = (build_workloads(32) if suite == "paper"
                 else adversarial_workloads(32))
    for w in workloads:
        tw = _port_workload(w)
        for m in LayoutMode:
            got = sim.simulate(tw, m, 32)
            want = jsim.simulate(w, JLayoutMode(int(m)), 32)
            assert got.total_s == want.total_s and got.agg_bw == want.agg_bw
            assert [dataclasses.asdict(r) for r in got.phases] == \
                [dataclasses.asdict(r) for r in want.phases]
        assert int(sim.best_mode(tw, 32)) == int(jsim.best_mode(w, 32))
        best = sim.best_scope_modes(tw, 32)
        assert {s: int(m) for s, m in best.items()} == \
            {s: int(m) for s, m in jsim.best_scope_modes(w, 32).items()}
        # a per-scope policy and a {scope: mode} mapping cost the same
        scopes = {s: m for s, m in best.items() if s}
        policy = LayoutPolicy.from_scopes(scopes, n_nodes=32)
        as_map = dict(scopes, **{"": LayoutMode.DIST_HASH})
        assert sim.simulate(tw, policy, 32).total_s == \
            sim.simulate(tw, as_map, 32).total_s


def test_custom_hardware_matches_the_reference():
    hw = dict(net_mibs=100.0, rpc_ms=0.2, ssd_iops=5000.0)
    for i, p in enumerate(_grid()[::3]):
        for m in LayoutMode:
            got = sim.simulate_phase(_port_phase(p), m, 16, sim.Hardware(**hw),
                                     seed=i)
            want = jsim.simulate_phase(p, JLayoutMode(int(m)), 16,
                                       jsim.Hardware(**hw), seed=i)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
