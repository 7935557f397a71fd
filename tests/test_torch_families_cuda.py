"""The MoE and VLM families on a CUDA card (marker ``cuda``): the reduced
deepseek-v2-lite-16b, moonshot-v1-16b-a3b and qwen2-vl-2b on the card
against the port's own CPU path (which ``tests/test_torch_families.py``
holds against the JAX package): forward logits with the routers' ids equal,
the three MoE dispatches with dropped copies, MLA decode over the latent
cache, a MoE train state saved and restored through the checkpoint
kernels, and the serve command line on the new archs.  Float32 throughout
(``rtol 1e-4, atol 1e-5``), weights at the per-layer fan-in (as
``chip_smoke.py``'s ``condition``).  Imports nothing of JAX, so it runs on
the card: ``python -m pytest -q -m cuda tests/test_torch_families_cuda.py``.
Skips elsewhere."""
import contextlib
import dataclasses
import math
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import (CHUNK_WORDS, CheckpointManager,
                                            CheckpointMeta, flatten_state)
from repro_torch.configs import all_configs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.core.layouts import str_hash
from repro_torch.kernels.chunk_router.chunk_router import \
    ROUTE_CHUNKS_SEGMENTED
from repro_torch.kernels.chunk_router.ops import leaf_table
from repro_torch.kernels.chunk_router.ref import route_chunks_segmented_ref
from repro_torch.kernels.fletcher.fletcher import (FLETCHER_SEGMENTED,
                                                   fletcher_segmented)
from repro_torch.kernels.fletcher.ops import as_words
from repro_torch.kernels.fletcher.ref import (fletcher_segmented_ref,
                                              n_chunks_of)
from repro_torch.models import attention as t_attn
from repro_torch.models import moe as tmoe
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step

ARCHS = ("deepseek-v2-lite-16b", "moonshot-v1-16b-a3b", "qwen2-vl-2b")
TOL = dict(rtol=1e-4, atol=1e-5)
B, S = 2, 24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _cfg(arch: str):
    return dataclasses.replace(all_configs()[arch].reduced(),
                               dtype="float32")


def _params(cfg):
    """The port's init on the CPU, every stacked matrix at its per-layer
    fan-in (an expert leaf's own input width; the router as drawn)."""
    params = build_model(cfg).init(0, "cpu")
    for path, leaf in iter_leaves(params["stack"]):
        if leaf.ndim >= 3 and path[-1] != "router":
            fan = leaf.shape[2] if "moe" in path and leaf.ndim == 4 else \
                leaf.shape[1]
            leaf.mul_(math.sqrt(leaf.shape[0] / fan))
    return params


def _batch(cfg, device):
    r = np.random.RandomState(0)
    batch = {"tokens": r.randint(0, 256, (B, S)).astype(np.int32),
             "targets": r.randint(0, 256, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = (0.02 * r.randn(B, 4, cfg.d_model)).astype(
            np.float32)
        batch["mrope_positions"] = np.stack(
            [np.broadcast_to(np.arange(S) // k, (B, S)) for k in (1, 2, 3)]
        ).astype(np.int32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


@contextlib.contextmanager
def _routing():
    """Every ``_router`` call's ids, as numpy."""
    calls, real = [], tmoe._router

    def router(params, x, cfg):
        out = real(params, x, cfg)
        calls.append(out[0].cpu().numpy())
        return out
    tmoe._router = router
    try:
        yield calls
    finally:
        tmoe._router = real


def _on(tree, device):
    return map_tree(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_family_forward_matches_cpu(cuda, arch):
    cfg = _cfg(arch)
    model, params = build_model(cfg), _params(cfg)
    with _routing() as on_cpu:
        want, aux_cpu = model.forward(params, _batch(cfg, "cpu"))
    with _routing() as on_card:
        got, aux_card = model.forward(_on(params, cuda), _batch(cfg, cuda))
    assert len(on_cpu) == len(on_card)
    for a, b in zip(on_cpu, on_card):
        np.testing.assert_array_equal(b, a)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    np.testing.assert_allclose(float(aux_card), float(aux_cpu), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", tmoe.IMPLS)
def test_cuda_apply_moe_matches_cpu(cuda, impl):
    """At capacity factor 0.5 (copies dropped): the same drops and
    outputs on the card as on the CPU."""
    cfg = _cfg("deepseek-v2-lite-16b")
    p = _params(cfg)["stack"]["seg1_moe"]["moe"]
    p = {k: v[0] for k, v in p.items()}
    x = torch.randn((B, S, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    want, _ = tmoe.apply_moe(p, x, cfg, impl=impl, capacity_factor=0.5)
    got, _ = tmoe.apply_moe(_on(p, cuda), x.to(cuda), cfg, impl=impl,
                            capacity_factor=0.5)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    ids, _, _ = tmoe._router(p, x.reshape(B * S, -1), cfg)
    C = tmoe.capacity(B * S, cfg.num_experts_per_tok, cfg.num_experts, 0.5)
    drops = tmoe.dropped_copies(ids.reshape(1, -1), cfg.num_experts, C)
    assert int(drops) > 0
    assert int(tmoe.dropped_copies(ids.reshape(1, -1).to(cuda),
                                   cfg.num_experts, C)) == int(drops)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_decode_steps_match_cpu(cuda, arch):
    """12 decode steps (MLA's latent cache for deepseek) on the card and on
    the CPU: logits and the cache written in place."""
    cfg = _cfg(arch)
    model, params = build_model(cfg), _params(cfg)
    toks = _batch(cfg, "cpu")["tokens"][:, :12]
    caches = {d: model.init_cache(B, 12, dtype="float32", device=d)
              for d in ("cpu", cuda)}
    on = {"cpu": params, cuda: _on(params, cuda)}
    for i in range(12):
        lg = {d: model.decode_step(on[d], caches[d], toks[:, i:i + 1].to(d),
                                   i + 1)[0].cpu().numpy() for d in on}
        np.testing.assert_allclose(lg[cuda], lg["cpu"], **TOL)
    for (path, a), (_, b) in zip(iter_leaves(caches["cpu"]),
                                 iter_leaves(caches[cuda])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), **TOL,
                                   err_msg=str(path))


@pytest.mark.cuda
def test_cuda_mla_latent_attention_against_float64(cuda):
    """The absorbed decode's latent attention on the card within 1e-5 of
    float64 at deepseek's widths (r 512, rope 64, 16 heads), cache 4096."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q_lat, q_pe = (torch.randn((2, 1, 16, n), generator=g, device=cuda)
                   for n in (512, 64))
    c_kv, k_pe = (torch.randn((2, 4096, n), generator=g, device=cuda)
                  .to(torch.bfloat16) for n in (512, 64))
    got = t_attn.mla_latent_attention(q_lat, q_pe, c_kv, k_pe, 4000,
                                      1 / math.sqrt(192))
    s = (torch.einsum("bshr,btr->bhst", q_lat.double(),
                      c_kv[:, :4000].double()) +
         torch.einsum("bshk,btk->bhst", q_pe.double(),
                      k_pe[:, :4000].double())) / math.sqrt(192)
    want = torch.einsum("bhst,btr->bshr", torch.softmax(s, -1),
                        c_kv[:, :4000].double())
    assert (got.double() - want).abs().max() < 1e-5


@pytest.mark.cuda
def test_cuda_moe_train_state_checkpoint_round_trip(cuda):
    """A reduced deepseek train step on the card, its state saved and
    restored through ``CheckpointManager``: one ``route_chunks_segmented``
    and one ``fletcher_segmented`` launch a save, both kernels equal to
    their plain versions on the state's leaves (the manifest's checksums
    too), and the restore bit for bit."""
    cfg = _cfg("deepseek-v2-lite-16b")
    model, opt = build_model(cfg), AdamW(warmup_steps=1, total_steps=2)
    params = _on(_params(cfg), cuda)
    params, ost, met = make_train_step(model, opt)(
        params, opt.init(params), _batch(cfg, cuda))
    assert np.isfinite(float(met["loss"])) and float(met["aux_loss"]) > 0
    state = (params, ost, torch.tensor([0, 1], dtype=torch.int32,
                                       device=cuda))
    policy = LayoutPolicy.from_scopes({"ckpt": LayoutMode.HYBRID}, n_nodes=8,
                                      default=LayoutMode.CENTRAL_META)
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, policy, async_save=False, device=cuda)
        for c in (ROUTE_CHUNKS_SEGMENTED, FLETCHER_SEGMENTED):
            c.launches = 0
        mgr.save(1, state)
        assert ROUTE_CHUNKS_SEGMENTED.launches == 1
        assert FLETCHER_SEGMENTED.launches == 1
        leaves = flatten_state(state)
        words = [as_words(t) for _, t in leaves]
        want = fletcher_segmented_ref(words, CHUNK_WORDS)
        assert torch.equal(fletcher_segmented(words, CHUNK_WORDS), want)
        meta = CheckpointMeta.from_json(
            (mgr.dir / "ckpt_1.json").read_text())
        assert np.array_equal([c["checksum"] for c in meta.chunks],
                              want.cpu().numpy())
        paths = [f"{mgr.scope}/1/{key}" for key, _ in leaves]
        counts = [n_chunks_of(w.numel(), CHUNK_WORDS) for w in words]
        table, offsets = leaf_table(
            [str_hash(p) for p in paths],
            [int(policy.mode_for_path(p)) for p in paths], counts)
        assert torch.equal(mgr.route(paths, counts, cuda)[0],
                           route_chunks_segmented_ref(
                               torch.as_tensor(table, device=cuda),
                               int(offsets[-1]), n_nodes=8))
        restored, step = mgr.restore(1, state)
    assert step == 1
    for (k, a), (_, b) in zip(flatten_state(restored), flatten_state(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_serve_command_line_takes_the_new_archs(cuda, arch):
    from repro_torch.launch import serve
    gen = serve.main(["--arch", arch, "--tokens", "8"])
    assert gen.shape == (4, 8)
    assert ((0 <= gen) & (gen < _cfg(arch).padded_vocab)).all()
