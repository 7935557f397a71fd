"""The recurrent, hybrid and audio families on a CUDA card (marker
``cuda``): the reduced xlstm-125m, hymba-1.5b and whisper-base on the card
against the port's own CPU path (which ``tests/test_torch_recurrent.py``
and ``tests/test_torch_encdec.py`` hold against the JAX package):
``forward`` and decode steps with the states written in place, the
doubling scan at a full chunk, and hymba's 4-layer train state saved and
restored through the checkpoint kernels, every launch held against its
plain version.  Float32 (``rtol 1e-4, atol 1e-5``).  Imports nothing of
JAX, so it runs on the card:
``python -m pytest -q -m cuda tests/test_torch_recurrent_cuda.py``.
Skips elsewhere."""
import dataclasses
import importlib.util
import math
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.manager import CheckpointManager, flatten_state
from repro_torch.configs import all_configs
from repro_torch.core.layouts import LayoutMode
from repro_torch.core.policy import LayoutPolicy
from repro_torch.kernels.chunk_router.chunk_router import \
    ROUTE_CHUNKS_SEGMENTED
from repro_torch.kernels.fletcher.fletcher import FLETCHER_SEGMENTED
from repro_torch.models import ssm
from repro_torch.models.param import iter_leaves, map_tree
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("xlstm-125m", "hymba-1.5b", "whisper-base")
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
    """The port's init on the CPU; Hymba's stacked matrices at their
    per-layer fan-in (conv kernel and A_log as drawn, as ``chip_smoke.py``'s
    ``condition``)."""
    params = build_model(cfg).init(0, "cpu")
    for path, leaf in iter_leaves(params.get("stack", {})):
        if leaf.ndim >= 3 and path[-1] not in ("conv_w", "a_log"):
            leaf.mul_(math.sqrt(leaf.shape[0] / leaf.shape[1]))
    return params


def _batch(cfg, device):
    r = np.random.RandomState(0)
    batch = {"tokens": r.randint(0, 256, (B, S)).astype(np.int32),
             "targets": r.randint(0, 256, (B, S)).astype(np.int32)}
    if cfg.family == "audio":
        batch["audio_embeds"] = r.randn(B, cfg.encoder_seq,
                                        cfg.d_model).astype(np.float32)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _on(tree, device):
    return map_tree(lambda t: t.to(device), tree)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_forward_matches_cpu(cuda, arch):
    cfg = _cfg(arch)
    model, params = build_model(cfg), _params(cfg)
    with torch.no_grad():
        want, _ = model.forward(params, _batch(cfg, "cpu"))
        got, _ = model.forward(_on(params, cuda), _batch(cfg, cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_decode_steps_match_cpu(cuda, arch):
    """12 decode steps on the card and on the CPU: logits, and the states
    (xLSTM's tuples, Hymba's SSM and conv tails, the KV caches) written in
    place."""
    cfg = _cfg(arch)
    model, params = build_model(cfg), _params(cfg)
    M = cfg.num_meta_tokens
    toks = _batch(cfg, "cpu")["tokens"][:, :12]
    caches = {d: model.init_cache(B, M + 12, dtype="float32", device=d)
              for d in ("cpu", cuda)}
    on = {"cpu": params, cuda: _on(params, cuda)}
    with torch.no_grad():
        for i in range(12):
            lg = {d: model.decode_step(on[d], caches[d],
                                       toks[:, i:i + 1].to(d),
                                       M + i + 1)[0].cpu().numpy()
                  for d in on}
            np.testing.assert_allclose(lg[cuda], lg["cpu"], **TOL)
    for (path, a), (_, b) in zip(iter_leaves(caches["cpu"]),
                                 iter_leaves(caches[cuda])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), **TOL,
                                   err_msg=str(path))


@pytest.mark.cuda
def test_cuda_mamba_scan_against_float64(cuda):
    """A 256-row chunk at hymba's widths (di 1600, N 16) on the card within
    1e-5 of a float64 recurrence, step by step."""
    g = torch.Generator(device=cuda).manual_seed(2)
    delta = torch.nn.functional.softplus(
        torch.randn((1, 256, 1600), generator=g, device=cuda) - 4.6)
    A = -torch.arange(1, 17, device=cuda, dtype=torch.float32)
    a = torch.exp(delta[..., None] * A)
    b = torch.randn((1, 256, 1600, 16), generator=g, device=cuda) * \
        delta[..., None]
    h, last = ssm.mamba_scan(a, b)
    want, hp = [], torch.zeros((1, 1600, 16), dtype=torch.float64,
                               device=cuda)
    for t in range(256):
        hp = a[:, t].double() * hp + b[:, t].double()
        want.append(hp)
    want = torch.stack(want, 1)
    assert (h.double() - want).abs().max() < 1e-5
    assert torch.equal(last, h[:, -1])


def _held_against_plain():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.HeldAgainstPlain()


@pytest.mark.cuda
def test_cuda_hymba_train_state_checkpoint_round_trip(cuda):
    """A reduced hymba (4 layers: global, swa, global, global) train step
    on the card, its state saved and restored through
    ``CheckpointManager``: one ``route_chunks_segmented`` and one
    ``fletcher_segmented`` launch a save, every launch of the save and the
    restore equal to the kernel's plain version on its own inputs
    (``chip_smoke.HeldAgainstPlain``), the restore bit for bit."""
    cfg = _cfg("hymba-1.5b")
    assert len(cfg.layer_kinds) == 4
    model, opt = build_model(cfg), AdamW(warmup_steps=1, total_steps=2)
    params = _on(_params(cfg), cuda)
    params, ost, met = make_train_step(model, opt)(
        params, opt.init(params), _batch(cfg, cuda))
    assert np.isfinite(float(met["loss"]))
    state = (params, ost, torch.tensor([0, 1], dtype=torch.int32,
                                       device=cuda))
    policy = LayoutPolicy.from_scopes({"ckpt": LayoutMode.HYBRID}, n_nodes=8,
                                      default=LayoutMode.CENTRAL_META)
    with tempfile.TemporaryDirectory() as d, _held_against_plain() as held:
        mgr = CheckpointManager(d, policy, async_save=False, device=cuda)
        for c in (ROUTE_CHUNKS_SEGMENTED, FLETCHER_SEGMENTED):
            c.launches = 0
        mgr.save(1, state)
        assert ROUTE_CHUNKS_SEGMENTED.launches == 1
        assert FLETCHER_SEGMENTED.launches == 1
        restored, step = mgr.restore(1, state)
    assert step == 1
    assert held.calls == {ROUTE_CHUNKS_SEGMENTED.name:
                          ROUTE_CHUNKS_SEGMENTED.launches,
                          FLETCHER_SEGMENTED.name:
                          FLETCHER_SEGMENTED.launches}
    for (k, a), (_, b) in zip(flatten_state(restored), flatten_state(state)):
        assert a.device.type == "cuda" and a.dtype == b.dtype, k
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8)), k


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_serve_command_line_takes_the_arch(cuda, arch):
    from repro_torch.launch import serve
    gen = serve.main(["--arch", arch, "--tokens", "8"])
    assert gen.shape == (4, 8)
    assert ((0 <= gen) & (gen < _cfg(arch).padded_vocab)).all()
