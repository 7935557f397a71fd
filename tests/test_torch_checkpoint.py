"""The port's checkpoint path against the JAX package: the plain versions of
the ``fletcher`` and ``route_chunks`` kernels against the reference's
oracles and Pallas kernels (interpret mode), the port's ``CheckpointManager``
against the JAX one on the same carried-across state (manifests and stored
chunks identical, node by node), and ports of tests/test_checkpoint.py.
The kernels themselves are held against their plain versions on the card in
test_torch_cuda.py."""
import json
import tempfile
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.layouts import LayoutMode as JMode
from repro.core.layouts import LayoutParams as JParams
from repro.core.layouts import route_data as j_route_data
from repro.core.policy import LayoutPolicy as JPolicy
from repro.kernels.chunk_router.chunk_router import route_chunks_kernel
from repro.kernels.chunk_router.ref import route_chunks_ref as j_route_ref
from repro.kernels.fletcher.fletcher import fletcher_kernel
from repro.kernels.fletcher.ref import fletcher_ref as j_fletcher_ref
from repro_torch.checkpoint.manager import (CHUNK_WORDS, CheckpointManager,
                                            flatten_state, unflatten_like)
from repro_torch.core.layouts import LayoutMode, LayoutParams, str_hash
from repro_torch.core.policy import LayoutPolicy
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.kernels.chunk_router.ops import (leaf_table, route_chunks,
                                                  route_leaves)
from repro_torch.kernels.chunk_router.ref import route_chunks_ref
from repro_torch.kernels.fletcher.ops import as_words, chunk_checksums
from repro_torch.kernels.fletcher.ref import fletcher_chunks_ref, fletcher_ref
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.train.optimizer import AdamWState

RNG = np.random.RandomState(11)
INT_MIN, INT_MAX = -2 ** 31, 2 ** 31 - 1


def _words(n, rng=RNG):
    w = rng.randint(INT_MIN, INT_MAX, n, dtype=np.int64).astype(np.int32)
    if n:
        w[rng.randint(0, n, max(1, n // 50))] = INT_MIN    # float -0.0
        w[rng.randint(0, n, max(1, n // 50))] = INT_MAX
        w[0] = INT_MIN
    return w



@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The shapes here are tiny: torch's default of a thread per core only
    spins against JAX's pool and the other test workers (a 10x slowdown)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# ---------------------------------------------------------------------------
# fletcher: plain version vs the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n", [0, 1, 7, 1000, 1023, 1025, 65536, 70001])
def test_fletcher_plain_matches_oracle(n):
    """One chunk over the whole array equals ``fletcher_ref`` on every
    word, INT_MIN (0x80000000) and INT_MAX included."""
    w = _words(n)
    want = j_fletcher_ref(w) if n else np.zeros(2, np.int32)
    got = fletcher_ref(torch.as_tensor(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        chunk_checksums(torch.as_tensor(w), max(n, 1))[0].numpy(), want)


@pytest.mark.parametrize("n,chunk", [(10, 4), (65536 * 2 + 3, 65536),
                                     (1000, 1000), (999, 1000), (5, 1),
                                     (0, 65536)])
def test_fletcher_chunks_restart_positions(n, chunk):
    """Chunk c is checksummed on its own, positions restarting at 1, as the
    manager does per stored chunk (``manager.py:181``); the last chunk may
    be short; an empty array is one empty chunk."""
    w = _words(n)
    got = chunk_checksums(torch.as_tensor(w), chunk).numpy()
    nc = max(1, -(-n // chunk))
    want = np.stack([j_fletcher_ref(w[c * chunk:(c + 1) * chunk])
                     if n else np.zeros(2, np.int32) for c in range(nc)])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        fletcher_chunks_ref(torch.as_tensor(w), chunk).numpy(), want)


def test_fletcher_pallas_kernel_disagrees_with_oracle_on_negative_zero():
    """Pinned reference fault: the Pallas body takes abs in int32, where
    abs(INT_MIN) stays negative, so the bits of -0.0 checksum differently
    from the int64 oracle the manager uses.  The port follows the oracle."""
    words = np.array([-0.0, 1.5], np.float32).view(np.int32)
    pallas = np.asarray(fletcher_kernel(jnp.asarray(words), interpret=True))
    oracle = j_fletcher_ref(words)
    np.testing.assert_array_equal(pallas, [1503, 44726])
    np.testing.assert_array_equal(oracle, [38606, 35492])
    np.testing.assert_array_equal(
        fletcher_ref(torch.as_tensor(words)).numpy(), oracle)


@pytest.mark.parametrize("n", [1, 257, 1024, 4097])
def test_fletcher_plain_matches_pallas_kernel_away_from_int_min(n):
    w = _words(n)
    w[w == INT_MIN] = 0
    pallas = np.asarray(fletcher_kernel(jnp.asarray(w), interpret=True))
    np.testing.assert_array_equal(fletcher_ref(torch.as_tensor(w)).numpy(),
                                  pallas)


def test_fletcher_detects_bitflip_and_swap():
    x = np.asarray(RNG.randint(0, 1000, 1000), np.int32)
    base = fletcher_ref(torch.as_tensor(x))
    x2 = x.copy()
    x2[123] ^= 1
    assert not torch.equal(fletcher_ref(torch.as_tensor(x2)), base)
    x3 = x.copy()
    x3[[10, 20]] = x3[[20, 10]]
    assert not torch.equal(fletcher_ref(torch.as_tensor(x3)), base)


@pytest.mark.parametrize("dtype,shape", [(torch.float32, (33, 17)),
                                         (torch.bfloat16, (5, 5, 5)),
                                         (torch.int32, ())])
def test_as_words_pads_like_the_manager(dtype, shape):
    t = torch.arange(int(np.prod(shape)) or 1).reshape(shape).to(dtype)
    raw = t.numpy().tobytes() if dtype != torch.bfloat16 else \
        t.view(torch.int16).numpy().tobytes()
    raw += b"\0" * (-len(raw) % 4)
    np.testing.assert_array_equal(as_words(t).numpy(),
                                  np.frombuffer(raw, np.int32))


# ---------------------------------------------------------------------------
# route_chunks: plain version vs the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mode", [1, 2, 3, 4])
@pytest.mark.parametrize("n,nodes", [(1, 32), (1000, 64), (4096, 32)])
def test_route_chunks_plain_matches_reference(mode, n, nodes):
    ph = RNG.randint(0, 2 ** 31 - 1, n).astype(np.int32)
    cid = RNG.randint(0, 1 << 20, n).astype(np.int32)
    cl = RNG.randint(0, nodes, n).astype(np.int32)
    jd, jc = route_chunks_kernel(jnp.asarray(ph), jnp.asarray(cid),
                                 jnp.asarray(cl), mode=mode, n_nodes=nodes,
                                 interpret=True)
    rd, rc = j_route_ref(jnp.asarray(ph), jnp.asarray(cid), jnp.asarray(cl),
                         mode=mode, n_nodes=nodes)
    np.testing.assert_array_equal(np.asarray(jd), np.asarray(rd))
    np.testing.assert_array_equal(np.asarray(jc), np.asarray(rc))
    d, c = route_chunks(torch.as_tensor(ph), torch.as_tensor(cid),
                        torch.as_tensor(cl), mode=mode, n_nodes=nodes)
    assert d.dtype == c.dtype == torch.int32
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    # equals route_data with no data location (the store's _dest)
    rdata = j_route_data(np.full(n, mode, np.int32), nodes, ph, cid, cl)
    np.testing.assert_array_equal(d.numpy(), np.asarray(rdata))


def test_route_chunks_out_of_range_client_counts_nowhere():
    """A client rank outside [0, n_nodes) is its own destination under
    modes 1/4 and counts nowhere, as in the Pallas kernel's one-hot."""
    cl = np.array([0, 5, -1, 9, 2], np.int32)
    z = np.zeros(5, np.int32)
    jd, jc = route_chunks_kernel(jnp.asarray(z), jnp.asarray(z),
                                 jnp.asarray(cl), mode=1, n_nodes=4,
                                 interpret=True)
    d, c = route_chunks_ref(torch.as_tensor(z), torch.as_tensor(z),
                            torch.as_tensor(cl), mode=1, n_nodes=4)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def _leaves(modes, n_chunks):
    hashes = RNG.randint(0, 2 ** 31 - 1, len(n_chunks))
    table, offsets = leaf_table(hashes, modes, n_chunks)
    return hashes, table, offsets


def _per_leaf(hashes, modes, n_chunks, nodes):
    """Each leaf routed alone, as the manager routed it with one
    ``route_chunks`` launch a leaf: descriptors (path hash, chunk id,
    chunk id mod N)."""
    out = []
    for ph, mode, n in zip(hashes, modes, n_chunks):
        cid = np.arange(n, dtype=np.int32)
        d, _ = route_chunks_ref(torch.full((n,), int(ph), dtype=torch.int32),
                                torch.as_tensor(cid),
                                torch.as_tensor(cid % nodes), mode=int(mode),
                                n_nodes=nodes)
        jd, _ = j_route_ref(jnp.full((n,), int(ph), jnp.int32),
                            jnp.asarray(cid), jnp.asarray(cid % nodes),
                            mode=int(mode), n_nodes=nodes)
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
        out.append(d.numpy())
    return out


@pytest.mark.parametrize("mode", [1, 2, 3, 4])
@pytest.mark.parametrize("nodes", [8, 32])
def test_route_leaves_plain_matches_per_leaf_routing(mode, nodes):
    """A whole checkpoint's leaf table (leaves of 1 to 4608 chunks) routed
    at once: each leaf's slice equals its own ``route_chunks`` routing
    (and the reference's oracle), bit for bit."""
    n_chunks = [1, 4608, 3, 257, 1, 64, 65]
    modes = [mode] * len(n_chunks)
    hashes, table, offsets = _leaves(modes, n_chunks)
    assert table.dtype == np.int32 and table.shape == (7, 3)
    np.testing.assert_array_equal(table[:, 2], offsets[:-1])
    dest = route_leaves(table, int(offsets[-1]), n_nodes=nodes, device="cpu")
    assert dest.dtype == torch.int32 and dest.numel() == sum(n_chunks)
    want = _per_leaf(hashes, modes, n_chunks, nodes)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(
            dest[offsets[i]:offsets[i + 1]].numpy(), w)


def test_route_leaves_mixed_modes_and_empty_leaves():
    """Leaves of different modes (a heterogeneous policy) and leaves with
    no chunks, which own no slice of the destinations."""
    n_chunks = [5, 0, 70, 0, 0, 1, 130]
    modes = [4, 2, 1, 3, 4, 3, 2]
    hashes, table, offsets = _leaves(modes, n_chunks)
    dest = route_leaves(table, int(offsets[-1]), n_nodes=16, device="cpu")
    want = _per_leaf(hashes, modes, n_chunks, 16)
    np.testing.assert_array_equal(dest.numpy(), np.concatenate(want))


def test_save_and_restore_route_every_leaf_in_one_call(monkeypatch):
    """One routing call a save and one a restore, whatever the number of
    leaves; the chunks land where per-leaf routing put them."""
    calls = []
    real = manager_mod.route_leaves

    def counted(table, n, **kw):
        calls.append(len(table))
        return real(table, n, **kw)

    monkeypatch.setattr(manager_mod, "route_leaves", counted)
    np_state = _np_state()
    policy = POLICIES[4][2]
    with tempfile.TemporaryDirectory() as d:
        tm = CheckpointManager(d, policy, async_save=False, device="cpu")
        tm.save(2, _torch_state(np_state))
        n_leaves = len(flatten_state(_torch_state(np_state)))
        assert calls == [n_leaves]
        restored, _ = tm.restore(2, _torch_state(np_state))
        assert calls == [n_leaves, n_leaves]
        for (k, a), (_, b) in zip(flatten_state(restored),
                                  flatten_state(_torch_state(np_state))):
            assert torch.equal(_bits(a), _bits(b)), k
        for key, t in flatten_state(_torch_state(np_state)):
            path = f"{tm.scope}/2/{key}"
            n = len(chunk_checksums(as_words(t), CHUNK_WORDS))
            cid = torch.arange(n, dtype=torch.int32)
            want, _ = route_chunks(torch.full_like(cid, str_hash(path)), cid,
                                   cid % 32, n_nodes=32,
                                   mode=int(policy.mode_for_path(path)))
            for c, node in enumerate(want.tolist()):
                assert (str_hash(path), c) in tm.store.nodes[node]


# ---------------------------------------------------------------------------
# the manager against the JAX manager
# ---------------------------------------------------------------------------
def _np_state(seed=0):
    """A train-state-shaped tree (params, AdamWState, cursor) of numpy
    leaves: multi-chunk leaves with a short last chunk, a bf16 leaf whose
    bytes are not a whole number of words, scalars."""
    r = np.random.RandomState(seed)
    import ml_dtypes
    params = {"embed": {"embedding": r.randn(3, 70001).astype(np.float32)},
              "ln_f": r.randn(64).astype(np.float32),
              "stack": {"seg0_local": {
                  "w": r.randn(2, 33, 17).astype(np.float32),
                  "m": r.randn(5, 5, 5).astype(ml_dtypes.bfloat16)}}}
    params["ln_f"][:4] = -0.0                     # the words 0x80000000
    mu = {k: v for k, v in params.items()}
    nu = {"embed": {"embedding": np.abs(params["embed"]["embedding"])},
          "ln_f": params["ln_f"] * 2, "stack": params["stack"]}
    return (params, (np.asarray(7, np.int32), mu, nu),
            np.asarray([0, 7], np.int32))


def _jax_state(np_state):
    from repro.train.optimizer import AdamWState as JAdamWState
    params, (step, mu, nu), cursor = np_state
    t = lambda x: jax.tree_util.tree_map(jnp.asarray, x)  # noqa: E731
    return (t(params), JAdamWState(jnp.asarray(step), t(mu), t(nu)),
            jnp.asarray(cursor))


def _torch_state(np_state):
    params, (step, mu, nu), cursor = np_state
    t = lambda x: jax.tree_util.tree_map(tensor_from_numpy, x)  # noqa: E731
    return (t(params), AdamWState(tensor_from_numpy(step), t(mu), t(nu)),
            tensor_from_numpy(cursor))


def _bits(t):
    """A tensor's bytes (so -0.0 and 0.0 differ)."""
    return t.reshape(-1).view(torch.uint8)


POLICIES = [
    ("mode1", JParams(JMode(1), 8), LayoutParams(LayoutMode(1), 8)),
    ("mode2", JParams(JMode(2), 8), LayoutParams(LayoutMode(2), 8)),
    ("mode3", JParams(JMode(3), 8), LayoutParams(LayoutMode(3), 8)),
    ("mode4", JParams(JMode(4), 8), LayoutParams(LayoutMode(4), 8)),
    ("hetero",
     JPolicy.from_scopes({"/bb/ckpt": JMode.HYBRID, "/bb/shared":
                          JMode.DIST_HASH}, n_nodes=32,
                         default=JMode.CENTRAL_META),
     LayoutPolicy.from_scopes({"/bb/ckpt": LayoutMode.HYBRID, "/bb/shared":
                               LayoutMode.DIST_HASH}, n_nodes=32,
                              default=LayoutMode.CENTRAL_META)),
    ("hetero-hashed-ckpt",
     JPolicy.from_scopes({"ckpt": JMode.DIST_HASH}, n_nodes=8,
                         default=JMode.NODE_LOCAL),
     LayoutPolicy.from_scopes({"ckpt": LayoutMode.DIST_HASH}, n_nodes=8,
                              default=LayoutMode.NODE_LOCAL)),
]


@pytest.mark.parametrize("name,jpol,tpol", POLICIES,
                         ids=[p[0] for p in POLICIES])
def test_manager_matches_jax_manager(name, jpol, tpol):
    """Same leaves → same manifest (keys, shapes, dtypes, nbytes, per-chunk
    checksums and sizes) and the same bytes at the same node for every
    chunk, under all four modes and heterogeneous policies."""
    np_state = _np_state()
    with tempfile.TemporaryDirectory() as dj, \
            tempfile.TemporaryDirectory() as dt:
        jm = JManager(dj, jpol, async_save=False)
        tm = CheckpointManager(dt, tpol, async_save=False, device="cpu")
        assert tm.scope == jm.scope
        jm.save(4, _jax_state(np_state))
        tm.save(4, _torch_state(np_state))
        jmeta = json.loads((jm.dir / "ckpt_4.json").read_text())
        tmeta = json.loads((tm.dir / "ckpt_4.json").read_text())
        assert tmeta == jmeta
        assert any(c["chunk_id"] == 3 for c in tmeta["chunks"])
        for jn, tn in zip(jm.store.nodes, tm.store.nodes):
            assert list(tn) == list(jn)
            for key in jn:
                assert tn[key] == jn[key]
        # the port restores what the JAX manager stored
        tm.store.nodes = jm.store.nodes
        restored, step = tm.restore(4, _torch_state(np_state))
        assert step == 4
        for (k, a), (_, b) in zip(flatten_state(restored),
                                  flatten_state(_torch_state(np_state))):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert torch.equal(_bits(a), _bits(b)), k


def test_flatten_keys_match_jax():
    np_state = _np_state()
    from repro.checkpoint.manager import _flatten_state
    jkeys = [k for k, _ in _flatten_state(_jax_state(np_state))[0]]
    tflat = flatten_state(_torch_state(np_state))
    assert [k for k, _ in tflat] == jkeys
    back = unflatten_like(_torch_state(np_state), dict(tflat))
    assert isinstance(back[1], AdamWState)
    assert [k for k, _ in flatten_state(back)] == jkeys


# ---------------------------------------------------------------------------
# ports of tests/test_checkpoint.py
# ---------------------------------------------------------------------------
def _mgr(tmp, mode=LayoutMode.NODE_LOCAL, **kw):
    return CheckpointManager(tmp, LayoutParams(mode=mode, n_nodes=8),
                             async_save=False, device="cpu", **kw)


def _state(seed=0):
    r = np.random.RandomState(seed)
    return {"w": torch.as_tensor(r.randn(33, 17).astype(np.float32)),
            "b": torch.as_tensor(r.randn(7).astype(np.float32)),
            "nested": {"m": torch.as_tensor(r.randn(5, 5, 5)).to(
                torch.bfloat16),
                "step": torch.tensor(13, dtype=torch.int32)}}


def _assert_same(a_tree, b_tree):
    for (ka, a), (kb, b) in zip(flatten_state(a_tree), flatten_state(b_tree)):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b)), ka


@pytest.mark.parametrize("mode", list(LayoutMode))
def test_roundtrip_all_modes(mode):
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, mode)
        state = _state()
        mgr.save(3, state)
        restored, step = mgr.restore(3, state)
        assert step == 3
        _assert_same(restored, state)


def test_corruption_detected():
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d)
        state = _state()
        mgr.save(1, state)
        node = next(n for n in mgr.store.nodes if n)
        key = next(iter(node))
        b = bytearray(node[key])
        b[0] ^= 0x01
        node[key] = bytes(b)
        with pytest.raises(IOError, match="checksum mismatch"):
            mgr.restore(1, state, verify=True)
        assert mgr.verify_failures == 1
        restored, _ = mgr.restore(1, state, verify=False)  # no check
        assert not torch.equal(restored["b"], state["b"]) or \
            not torch.equal(restored["w"], state["w"])


def test_truncated_and_missing_chunks_are_detected():
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d)
        state = {"w": torch.arange(CHUNK_WORDS * 2 + 5, dtype=torch.int32)}
        mgr.save(1, state)
        node = next(n for n in mgr.store.nodes if n)
        key = next(iter(node))
        node[key] = node[key][:-4]
        with pytest.raises(IOError, match="checksum mismatch"):
            mgr.restore(1, state)
        del node[key]
        with pytest.raises(IOError, match="missing chunk"):
            mgr.restore(1, state)
        assert mgr.verify_failures == 1


def test_elastic_restore_across_layouts():
    """A checkpoint written under Mode 1 restores under Mode 3."""
    with tempfile.TemporaryDirectory() as d:
        m1 = _mgr(d, LayoutMode.NODE_LOCAL)
        state = _state()
        m1.save(5, state)
        m3 = _mgr(d, LayoutMode.DIST_HASH)
        m3.store = m1.store
        restored, _ = m3.restore(5, state)
        assert torch.equal(restored["w"], state["w"])


def test_roundtrip_under_heterogeneous_policy():
    policy = LayoutPolicy.from_scopes(
        {"ckpt": LayoutMode.HYBRID}, n_nodes=8,
        default=LayoutMode.DIST_HASH)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, policy, async_save=False, device="cpu")
        state = _state()
        mgr.save(3, state)
        restored, step = mgr.restore(3, state)
        assert step == 3
        _assert_same(restored, state)


def test_selector_style_scope_applies_to_checkpoints():
    policy = LayoutPolicy.from_scopes(
        {"/bb/ckpt": LayoutMode.NODE_LOCAL,
         "/bb/shared": LayoutMode.CENTRAL_META},
        n_nodes=8, default=LayoutMode.DIST_HASH)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, policy, async_save=False, device="cpu")
        assert mgr.scope == "/bb/ckpt"
        state = _state()
        mgr.save(2, state)
        meta = json.loads((mgr.dir / "ckpt_2.json").read_text())
        assert meta["layout_mode"] == int(LayoutMode.NODE_LOCAL)
        for node_id, node in enumerate(mgr.store.nodes):
            for (_, cid) in node:
                assert cid % 8 == node_id
        restored, _ = mgr.restore(2, state)
        assert torch.equal(restored["w"], state["w"])
        mgr2 = CheckpointManager(d, policy, async_save=False,
                                 scope="/bb/shared", device="cpu")
        assert mgr2.scope == "/bb/shared"


def test_gc_keeps_newest_manifests_and_every_chunk():
    """Manifests beyond ``keep`` go; their chunks stay in the store, as in
    the reference (ROADMAP Queue 3)."""
    with tempfile.TemporaryDirectory() as d:
        mgr = _mgr(d, keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, _state(s))
        assert mgr.latest_step() == 4
        steps = sorted(int(p.stem.split("_")[1])
                       for p in mgr.dir.glob("ckpt_*.json"))
        assert steps == [3, 4]
        assert sum(len(n) for n in mgr.store.nodes) == 4 * 4


def test_async_save_completes_and_does_not_hold_the_state():
    """The save copies the state before it returns: changing the tensors
    afterwards does not change what is stored."""
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, LayoutParams(mode=LayoutMode.HYBRID,
                                                n_nodes=8), async_save=True,
                                device="cpu")
        state = _state()
        want = {k: v.clone() for k, v in state.items() if k != "nested"}
        gate, store = threading.Event(), mgr._save_sync
        mgr._save_sync = lambda *a: (gate.wait(10), store(*a))
        mgr.save(9, state)
        state["b"].add_(1.0)          # while the save thread still waits
        gate.set()
        mgr.wait()
        restored, _ = mgr.restore(9, _state())
        assert torch.equal(restored["b"], want["b"])
        assert torch.equal(restored["w"], want["w"])


def test_async_save_error_surfaces_on_wait():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, LayoutParams(mode=LayoutMode.HYBRID,
                                                n_nodes=8), async_save=True,
                                device="cpu")
        mgr.dir = mgr.dir / "missing" / "dir"      # manifest write fails
        mgr.save(1, _state())
        with pytest.raises(FileNotFoundError):
            mgr.wait()
        mgr.wait()                                  # reported once
