"""The port's routing triplet and policy against repro.core.layouts /
repro.core.policy: bit for bit on 100k random (path, chunk, client) triples
in every mode."""
import numpy as np
import pytest
import torch

from repro.core import layouts as jl
from repro.core.policy import LayoutPolicy as JLayoutPolicy
from repro_torch.core import layouts as tl
from repro_torch.core.policy import SCOPE_NONE, LayoutPolicy, as_policy

N_PAIRS = 100_000


def _triples(seed, n_nodes):
    rng = np.random.RandomState(seed)
    ph = rng.randint(0, 2 ** 31 - 1, N_PAIRS).astype(np.int32)
    cid = rng.randint(0, 2 ** 31 - 1, N_PAIRS).astype(np.int32)
    cid[:1000] = rng.randint(-2 ** 31, 0, 1000)      # negative ids too
    client = rng.randint(0, n_nodes, N_PAIRS).astype(np.int32)
    return ph, cid, client


def test_mix_hash_matches_reference_bit_for_bit():
    ph, cid, _ = _triples(0, 8)
    ref = jl.mix_hash(np, ph, cid)
    got = tl.mix_hash(torch.as_tensor(ph), torch.as_tensor(cid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref >= 0).all()


@pytest.mark.parametrize("n_nodes", [8, 32])
@pytest.mark.parametrize("mode", list(jl.LayoutMode))
def test_route_data_and_meta_match_reference(mode, n_nodes):
    ph, cid, client = _triples(int(mode) * 7 + n_nodes, n_nodes)
    modes = np.full(N_PAIRS, int(mode), np.int32)
    loc = np.random.RandomState(1).randint(0, n_nodes, N_PAIRS).astype(
        np.int32)
    t = torch.as_tensor
    for data_loc in (None, loc):
        ref = jl.route_data(modes, n_nodes, ph, cid, client,
                            data_loc=data_loc)
        got = tl.route_data(t(modes), n_nodes, t(ph), t(cid), t(client),
                            data_loc=None if data_loc is None else t(loc))
        np.testing.assert_array_equal(got.numpy(), ref)
    n_md = jl.LayoutParams(mode, n_nodes).n_md_servers
    ref = jl.route_meta(modes, n_nodes, n_md, ph, client)
    got = tl.route_meta(t(modes), n_nodes, n_md, t(ph), t(client))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.dtype == torch.int32


def test_mixed_mode_routing_matches_reference():
    ph, cid, client = _triples(5, 32)
    modes = np.random.RandomState(2).randint(1, 5, N_PAIRS).astype(np.int32)
    t = torch.as_tensor
    np.testing.assert_array_equal(
        tl.route_data(t(modes), 32, t(ph), t(cid), t(client)).numpy(),
        jl.route_data(modes, 32, ph, cid, client))
    np.testing.assert_array_equal(
        tl.route_meta(t(modes), 32, 4, t(ph), t(client)).numpy(),
        jl.route_meta(modes, 32, 4, ph, client))


@pytest.mark.parametrize("path", ["", "/", "/bb/ckpt/rank3/f0",
                                  "/bb/shared/ü-ñ", "x" * 300])
def test_str_hash_matches_reference(path):
    assert tl.str_hash(path) == jl.str_hash(path)


def test_policy_copy_resolves_like_reference():
    scopes = {"/bb": tl.LayoutMode.DIST_HASH,
              "/bb/ckpt": tl.LayoutMode.HYBRID,
              "/bb/ckpt/meta/": tl.LayoutMode.CENTRAL_META}
    jp = JLayoutPolicy.from_scopes(scopes, n_nodes=16,
                                   default=jl.LayoutMode.NODE_LOCAL)
    tp = LayoutPolicy.from_scopes(scopes, n_nodes=16,
                                  default=tl.LayoutMode.NODE_LOCAL)
    paths = ["/bb/ckpt/rank3/f0", "/bb/ckpt", "/bb/ckptX", "/bb/other",
             "/elsewhere", "/bb/ckpt/meta/x", "/"]
    for p in paths:
        assert tp.scope_of(p) == jp.scope_of(p)
        assert int(tp.mode_for_path(p)) == int(jp.mode_for_path(p))
        assert tp.scope_hash_of(p) == jp.scope_hash_of(p)
    assert tp.scope_hash_of("/elsewhere") == SCOPE_NONE
    sh = np.asarray([jp.scope_hash_of(p) for p in paths], np.int32)
    np.testing.assert_array_equal(tp.resolve(torch.as_tensor(sh)).numpy(),
                                  jp.resolve(sh))
    assert tp.n_md_servers == jp.n_md_servers
    assert tp.table == jp.table
    assert tp.mode_array((2, 3), "cpu").tolist() == [[1, 1, 1]] * 2
    legacy = as_policy(tl.LayoutParams(tl.LayoutMode.HYBRID, 8))
    assert legacy.default_mode == tl.LayoutMode.HYBRID
    with pytest.raises(TypeError):
        as_policy("not a policy")
