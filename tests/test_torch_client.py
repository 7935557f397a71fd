"""The port's BBClient against the JAX BBClient: the pinned client-trace
digests on both exchange planes, the mixed-mode lifecycle element for
element under every exchange configuration, state carried across from the
JAX engine, and losslessness of the carry round at tiny budgets.  Bitwise
everywhere: the engine is integer."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.client import BBClient as JBBClient
from repro.core.client import BBRequest as JBBRequest
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import burst_buffer as bb
from repro_torch.core.client import BBClient, BBRequest
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy

from test_policy import SEED_DIGESTS
from test_torch_engine import assert_state_equal, digest, t32

N, Q, W = 8, 5, 8
SCOPES = {"/bb/ckpt": LayoutMode.HYBRID, "/bb/shared": LayoutMode.DIST_HASH}


def client_trace(mode, exchange, device="cpu"):
    """``test_compacted_exchange._client_trace`` through the port."""
    client = BBClient(LayoutPolicy.uniform(mode, N), device=device, cap=64,
                      words=W, mcap=64, exchange=exchange)
    rng = np.random.RandomState(42)
    dev = lambda x: t32(x).to(device)                        # noqa: E731
    ph = dev(rng.randint(1, 1 << 20, (N, Q)))
    cid = dev(rng.randint(0, 4, (N, Q)))
    payload = dev(rng.randint(0, 9999, (N, Q, W)))
    client.write(BBRequest(path_hash=ph, chunk_id=cid, payload=payload))
    state = digest(*bb.to_numpy(client.state))
    perm = torch.as_tensor(rng.permutation(N), device=device)
    rpay, rfound = client.read(BBRequest(path_hash=ph[perm],
                                         chunk_id=cid[perm]))
    fnd, size, loc = client.stat(BBRequest(path_hash=ph))
    return {"state": state, "read": digest(rpay, rfound),
            "meta": digest(fnd, size, loc)}


@pytest.mark.parametrize("exchange", ["dense", "compacted"])
@pytest.mark.parametrize("mode", list(LayoutMode))
def test_client_trace_reproduces_seed_digests(mode, exchange):
    assert client_trace(mode, exchange) == SEED_DIGESTS[int(mode)]


def _paths(q, tag=""):
    return [[(f"/bb/ckpt/rank{r}/f{j % 2}{tag}" if j % 3 == 0 else
              f"/bb/shared/obj{(r * q + j) % 11}{tag}" if j % 3 == 1 else
              f"/bb/other/g{r * q + j}{tag}") for j in range(q)]
            for r in range(N)]


def _unique_paths(q):
    return [[(f"/bb/ckpt/rank{r}/f{j}", f"/bb/shared/obj{r}-{j}",
              f"/bb/other/g{r}-{j}")[j % 3] for j in range(q)]
            for r in range(N)]


def _pair(**kw):
    """A JAX client and a port client over the hetero policy."""
    jpol = JLayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2)
    tpol = LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2)
    args = dict(cap=128, words=W, mcap=64, **kw)
    return JBBClient(jpol, **args), BBClient(tpol, device="cpu", **args)


def _requests(jc, tc, paths, rng, q, valid_p=0.2):
    cid = rng.randint(0, 4, (N, q))
    payload = rng.randint(0, 9999, (N, q, W))
    valid = rng.rand(N, q) > valid_p
    return (jc.encode(paths, chunk_id=cid, payload=payload, valid=valid),
            tc.encode(paths, chunk_id=cid, payload=payload, valid=valid))


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy())


LIFECYCLE_CONFIGS = [
    dict(exchange="compacted"),                    # ragged, two-phase, fused
    dict(exchange="dense"),
    dict(exchange="auto"),
    dict(exchange="compacted", pipeline=False),    # serial write rounds
    dict(exchange="compacted", two_phase=False),   # one-call hybrid read
    dict(exchange="compacted", ragged=False),      # uniform B = q
    dict(exchange="compacted", budget=2),          # carry round + hint
]


@pytest.mark.parametrize("kw", LIFECYCLE_CONFIGS,
                         ids=lambda kw: "-".join(f"{k}={v}"
                                                 for k, v in kw.items()))
def test_mixed_mode_lifecycle_matches_jax_client(kw):
    """write, overwrite, read (cross-node rows), stat, create, remove,
    stat, read — under the hetero policy, every table and every reply
    equal to the JAX client's after every step."""
    q = 6
    rng = np.random.RandomState(3)
    jc, tc = _pair(**kw)
    jr, tr = _requests(jc, tc, _paths(q), rng, q)
    jc.write(jr)
    tc.write(tr)
    assert_state_equal(jc.state, tc.state)
    jr2, tr2 = _requests(jc, tc, _paths(q, tag="b"), rng, q, valid_p=0.1)
    jc.write(jr2)
    tc.write(tr2)
    jc.write(jr)                                  # new versions of chunks
    tc.write(tr)
    assert_state_equal(jc.state, tc.state)
    perm = rng.permutation(N)
    jread = JBBRequest(path_hash=jr.path_hash[perm],
                       chunk_id=jr.chunk_id[perm],
                       scope_hash=jr.scope_hash[perm])
    tread = BBRequest(path_hash=tr.path_hash[perm],
                      chunk_id=tr.chunk_id[perm],
                      scope_hash=tr.scope_hash[perm])
    for a, b in zip(jc.read(jread), tc.read(tread)):
        _same(a, b)
    assert bool(tc.read(tread)[1].any())
    for a, b in zip(jc.stat(jr), tc.stat(tr)):
        _same(a, b)
    jnew, tnew = _requests(jc, tc, _paths(q, tag="new"), rng, q)
    _same(jc.create(jnew), tc.create(tnew))
    _same(jc.create(jr), tc.create(tr))            # idempotent on existing
    assert_state_equal(jc.state, tc.state)
    _same(jc.remove(jr), tc.remove(tr))
    assert_state_equal(jc.state, tc.state)
    for a, b in zip(jc.stat(jr), tc.stat(tr)):
        _same(a, b)
    for a, b in zip(jc.read(jr2), tc.read(tr2)):
        _same(a, b)


def test_port_reads_tables_written_by_jax():
    """State carried across: the JAX client writes, the port adopts its
    tables through ``from_jax_state`` and answers reads and stats exactly
    as the JAX client does."""
    q = 6
    rng = np.random.RandomState(11)
    jc, _ = _pair(exchange="compacted")
    cid = rng.randint(0, 4, (N, q))
    payload = rng.randint(0, 9999, (N, q, W))
    jc.write(jc.encode(_unique_paths(q), chunk_id=cid, payload=payload))
    arrays = [np.asarray(a) for a in jc.state.tree_flatten()[0]]
    tc = BBClient(LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2),
                  device="cpu", words=W,
                  state=bb.from_jax_state(arrays, device="cpu"))
    treq = tc.encode(_unique_paths(q), chunk_id=cid)
    jreq = jc.encode(_unique_paths(q), chunk_id=cid)
    jpay, jfound = jc.read(jreq)
    tpay, tfound = tc.read(treq)
    _same(jpay, tpay)
    _same(jfound, tfound)
    assert bool(tfound.all())
    np.testing.assert_array_equal(tpay.numpy(), payload)
    for a, b in zip(jc.stat(jreq), tc.stat(treq)):
        _same(a, b)


@pytest.mark.parametrize("budget", [1, 2, 4, 16])
def test_carry_round_is_lossless_at_any_budget(budget):
    """Budgets {1, 2, q/4, q} with q = 16: the carry round delivers every
    chunk and metadata op (dropped == 0), and the tables and replies are
    the JAX client's at the same budget."""
    n, q, w = 4, 16, 4
    rng = np.random.RandomState(budget)
    ph = np.repeat(rng.randint(1, 1 << 20, (n, 2)), q // 2, axis=1)
    cid = np.tile(np.arange(q // 2), (n, 2))
    payload = rng.randint(0, 9999, (n, q, w))
    jc = JBBClient(JLayoutPolicy.uniform(3, n), cap=64, words=w, mcap=32,
                   exchange="compacted", budget=budget)
    tc = BBClient(LayoutPolicy.uniform(3, n), device="cpu", cap=64, words=w,
                  mcap=32, exchange="compacted", budget=budget)
    jc.write(JBBRequest(path_hash=jnp.asarray(ph, jnp.int32),
                        chunk_id=jnp.asarray(cid, jnp.int32),
                        payload=jnp.asarray(payload, jnp.int32)))
    treq = BBRequest(path_hash=t32(ph), chunk_id=t32(cid),
                     payload=t32(payload))
    tc.write(treq)
    assert int(tc.state.dropped.sum()) == 0
    assert_state_equal(jc.state, tc.state)
    jreq = JBBRequest(path_hash=jnp.asarray(ph, jnp.int32),
                      chunk_id=jnp.asarray(cid, jnp.int32))
    out, found = tc.read(treq)
    assert bool(found.all())
    np.testing.assert_array_equal(out.numpy(), payload)
    for a, b in zip(jc.read(jreq), (out, found)):
        _same(a, b)
    fnd, size, _ = tc.stat(treq)
    assert bool(fnd.all()) and bool((size == q // 2).all())


def test_float_payload_truncates_like_jax():
    """A float32 payload truncates into the int32 tables and never promotes
    the routing keys of the request buffer."""
    n, q, w = 4, 8, 4
    rng = np.random.RandomState(5)
    ph = rng.randint(1 << 25, 1 << 30, (n, q))
    payload = (rng.rand(n, q, w) * 1000).astype(np.float32)
    jc = JBBClient(JLayoutPolicy.uniform(3, n), cap=64, words=w, mcap=64,
                   exchange="compacted")
    tc = BBClient(LayoutPolicy.uniform(3, n), device="cpu", cap=64, words=w,
                  mcap=64, exchange="compacted")
    jc.write(JBBRequest(path_hash=jnp.asarray(ph, jnp.int32),
                        chunk_id=jnp.zeros((n, q), jnp.int32),
                        payload=jnp.asarray(payload)))
    tc.write(BBRequest(path_hash=t32(ph), chunk_id=t32(np.zeros((n, q))),
                       payload=torch.as_tensor(payload)))
    assert_state_equal(jc.state, tc.state)
    _, found = tc.read(BBRequest(path_hash=t32(ph)))
    assert bool(found.all())


def test_client_validation():
    pol = LayoutPolicy.from_scopes({"/a": LayoutMode.HYBRID}, n_nodes=2)
    with pytest.raises(ValueError, match="unknown exchange"):
        BBClient(pol, device="cpu", exchange="nope")
    c = BBClient(pol, device="cpu", cap=8, words=2, mcap=8)
    bad = BBRequest(path_hash=t32(np.ones((2, 1))),
                    mode=t32(np.full((2, 1), int(LayoutMode.NODE_LOCAL))))
    with pytest.raises(ValueError, match="modes_present"):
        c.stat(bad)
    with pytest.raises(ValueError, match="payload"):
        c.write(BBRequest(path_hash=t32(np.ones((2, 1)))))
    req = c.encode([[], []])
    assert tuple(req.path_hash.shape) == (2, 0)
    assert tuple(req.scope_hash.shape) == (2, 0)
    with pytest.raises(ValueError, match="lives on"):
        BBClient(pol, device="meta", state=c.state)


def test_client_requires_a_device_without_cuda(monkeypatch):
    """With no card and no explicit device the client raises instead of
    falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BBClient(LayoutPolicy.uniform(LayoutMode.DIST_HASH, 2))


def test_auto_pick_follows_the_fallback_table():
    """The fallback table is the reference's, and a pick from it (the
    explicit-table, nearest-cell path) is the reference's."""
    from repro.core import exchange_select as jsel
    from repro_torch.core import exchange_select
    table = exchange_select.FALLBACK_TABLE
    assert table == jsel.FALLBACK_TABLE
    assert exchange_select.pick_backend(4, 8, 8, table) == "dense"
    assert exchange_select.pick_backend(32, 8, 262144, table) == "compacted"
    assert exchange_select.pick_backend(64, 256, 16, table) == "compacted"
    for n, q, w, _ in table:
        assert exchange_select.pick_backend(n, q, w, table) == \
            jsel.pick_backend(n, q, w, table)


# N x q x words of the comparison in ROADMAP Queue 3a item 2: 288 shapes
PICK_QS = (1, 4, 8, 16, 32, 64, 128, 256)
PICK_WORDS = (1, 4, 16, 64, 1024, 262147)


@pytest.mark.parametrize("n_nodes", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("path", ["auto", "explicit"])
def test_pick_backend_matches_reference_on_the_grid(n_nodes, path):
    """``exchange="auto"`` picks the reference's plane: the stump fit from
    the committed artifacts, and the nearest cell of an explicit table."""
    from repro.core import exchange_select as jsel
    from repro_torch.core import exchange_select
    table = jsel.load_crossover() if path == "explicit" else None
    for q in PICK_QS:
        for w in PICK_WORDS:
            assert exchange_select.pick_backend(n_nodes, q, w, table) == \
                jsel.pick_backend(n_nodes, q, w, table), (n_nodes, q, w)
    if path == "auto" and n_nodes == 32:        # chip_smoke.py's shape
        assert exchange_select.pick_backend(32, 8, 262147) == "compacted"


def _artifacts(tmp_path, case):
    """A directory of benchmark artifacts, well formed or not."""
    import json
    root = tmp_path / case
    root.mkdir()
    row = dict(n_nodes=4, batch=8, words=8, write_us=1.0, read_us=1.0,
               stat_us=1.0)
    if case == "not_json":
        (root / "BENCH_pr3.json").write_text("{rows: [")
    elif case == "bad_rows":
        (root / "BENCH_pr3.json").write_text(json.dumps(
            {"rows": [7, {"n_nodes": "x"}, dict(row, backend="dense")]}))
    elif case == "fallback_file":
        (root / "BENCH_pr3.json").write_text("[]")
        (root / "BENCH_pr2.json").write_text(json.dumps({"rows": [
            dict(row, backend="dense"),
            dict(row, backend="compacted", read_us=0.5),
            dict(row, n_nodes=16, batch=64, backend="dense", read_us=9.0),
            dict(row, n_nodes=16, batch=64, backend="compacted")]}))
    elif case == "fabric":
        (root / "BENCH_pr5.json").write_text(json.dumps({"fabric": {
            "rows": [{"us_per_call": 10.0, "exchanged_bytes": 1000},
                     {"us_per_call": 30.0, "exchanged_bytes": 9000},
                     {"us_per_call": "x"}]}}))
    elif case == "flat_fabric":
        (root / "BENCH_pr5.json").write_text(json.dumps({"fabric": {
            "rows": [{"us_per_call": 10.0, "exchanged_bytes": 1000},
                     {"us_per_call": 10.0, "exchanged_bytes": 1000}]}}))
    return str(root)


@pytest.mark.parametrize("case", ["repo", "missing", "not_json", "bad_rows",
                                  "fallback_file", "fabric", "flat_fabric"])
def test_crossover_loaders_match_reference(tmp_path, case):
    """``load_crossover``, ``fabric_model`` and ``auto_accuracy`` give the
    reference's values on the committed artifacts and on missing or
    malformed ones."""
    from repro.core import exchange_select as jsel
    from repro_torch.core import exchange_select
    root = None if case == "repo" else _artifacts(tmp_path, case)
    table = exchange_select.load_crossover(root)
    assert table == jsel.load_crossover(root)
    assert exchange_select.fabric_model(root) == jsel.fabric_model(root)
    assert exchange_select.auto_accuracy(table) == jsel.auto_accuracy(table)
    if case == "repo":
        assert table != exchange_select.FALLBACK_TABLE
        assert exchange_select.fabric_model()[2]


def test_adopted_state_is_not_changed_under_its_caller():
    """One state adopted by two clients, each writing something else: the
    state stays as it was, and each client's tables equal a JAX client's
    that adopted the same state (JAX arrays are immutable)."""
    rng = np.random.RandomState(11)
    q = 4
    jc0, tc0 = _pair(exchange="compacted")
    jr, tr = _requests(jc0, tc0, _paths(q), rng, q)
    jc0.write(jr)
    tc0.write(tr)
    js, ts = jc0.state, tc0.state
    snapshot = bb.to_numpy(ts)
    jpol = JLayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2)
    tpol = LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2)
    for tag in ("x", "y"):
        jc = JBBClient(jpol, words=W, state=js, exchange="compacted")
        tc = BBClient(tpol, device="cpu", words=W, state=ts,
                      exchange="compacted")
        jr2, tr2 = _requests(jc, tc, _paths(q, tag=tag), rng, q)
        jc.write(jr2)
        tc.write(tr2)
        jc.remove(jr)
        tc.remove(tr)
        assert_state_equal(jc.state, tc.state)
        for a, b in zip(snapshot, bb.to_numpy(ts)):
            np.testing.assert_array_equal(a, b)
    assert_state_equal(js, ts)


def test_donated_state_is_adopted_in_place():
    """``donate=True``: the client takes the caller's tables themselves."""
    _, tc0 = _pair(exchange="compacted")
    ts = tc0.state
    tc = BBClient(LayoutPolicy.from_scopes(SCOPES, n_nodes=N, default=2),
                  device="cpu", words=W, state=ts, donate=True)
    assert tc.state is ts
    before = ts.data_count.clone()
    rng = np.random.RandomState(5)
    tr = tc.encode(_unique_paths(3), chunk_id=rng.randint(0, 4, (N, 3)),
                   payload=rng.randint(0, 99, (N, 3, W)))
    tc.write(tr)
    assert int(ts.data_count.sum()) > int(before.sum())


@pytest.mark.parametrize("exchange", ["dense", "compacted"])
def test_all_invalid_and_empty_batches(exchange):
    """A batch with no valid slot (zero-width ragged plans, empty receive
    views) and a q = 0 batch run every call and match the JAX client."""
    jc, tc = _pair(exchange=exchange)
    q = 4
    cid, payload = np.zeros((N, q), np.int32), np.ones((N, q, W), np.int32)
    invalid = np.zeros((N, q), bool)
    jr = jc.encode(_unique_paths(q), chunk_id=cid, payload=payload,
                   valid=invalid)
    tr = tc.encode(_unique_paths(q), chunk_id=cid, payload=payload,
                   valid=invalid)
    jc.write(jr)
    tc.write(tr)
    assert_state_equal(jc.state, tc.state)
    for a, b in zip(jc.read(jr), tc.read(tr)):
        _same(a, b)
    for a, b in zip(jc.stat(jr), tc.stat(tr)):
        _same(a, b)
    _same(jc.remove(jr), tc.remove(tr))
    empty = tc.encode([[] for _ in range(N)])
    out, found = tc.read(empty)
    assert tuple(out.shape) == (N, 0, W) and tuple(found.shape) == (N, 0)
    assert tuple(tc.stat(empty)[0].shape) == (N, 0)
