"""The port's gradient compression, pipeline and sharded restore against the
JAX package.

In-process: both compressors bit for bit against the reference's on the
same numpy gradients over three error-feedback steps, the reference's
error-feedback property on the port, and the fault both packages share:
``make_train_step(compressor=...)`` calls ``compressor(grads)``, which no
compressor accepts (ROADMAP 3b).

On four spawned gloo ranks (one spawn for the module, one thread a rank):
``gpipe_apply`` against ``sequential_ref`` (bit for bit) and against the
reference's ``gpipe_apply`` on four host devices (run in a subprocess, as
``tests/test_train_substrate.py``'s ``PP_SCRIPT``); and
``CheckpointManager.restore(shardings=...)`` of a reduced gemma3-1b train
state onto a (2, 2) ``("data", "model")`` and a (2, 2, 1) ``("pod",
"data", "model")`` ``DeviceMesh``: every rank's local shard of every leaf
equals the slice that the reference's ``NamedSharding.devices_indices_map``
gives the device in the same place of the same mesh, the two-axis
``("pod", "data")`` dims included; ``shardings=None`` restores plain
tensors as before.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_configs as j_all_configs
from repro.distributed.compression import Int8Compressor as JInt8
from repro.distributed.compression import TopKCompressor as JTopK
from repro.models.registry import build_model as j_build_model
from repro.train.optimizer import AdamW as JAdamW
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import all_configs
from repro_torch.distributed.compression import (Int8Compressor,
                                                 TopKCompressor)
from repro_torch.models.registry import build_model
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import make_train_step

ROOT = Path(__file__).resolve().parents[1]
#: seconds the rank group and the reference's subprocess may run
GROUP_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------
def _grads(rng, step):
    return {"w": rng.randn(32, 8).astype(np.float32) * (1 + step),
            "emb": {"table": rng.randn(257, 3).astype(np.float32)},
            "n": np.float32(rng.randn(5)),
            "ties": np.repeat(rng.randn(4).astype(np.float32), 8)}


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_same(a, b, path=""):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


@pytest.mark.parametrize("comp,jcomp", [
    (Int8Compressor(), JInt8()), (TopKCompressor(0.1), JTopK(0.1)),
    (TopKCompressor(0.25), JTopK(0.25))], ids=["int8", "topk0.1",
                                               "topk0.25"])
def test_compressors_match_reference_bit_for_bit(comp, jcomp):
    rng = np.random.RandomState(7)
    g0 = _grads(rng, 0)
    to_t = lambda t: {k: to_t(v) for k, v in t.items()} \
        if isinstance(t, dict) else torch.as_tensor(np.asarray(t))
    to_j = lambda t: {k: to_j(v) for k, v in t.items()} \
        if isinstance(t, dict) else jnp.asarray(t)
    res, jres = comp.init(to_t(g0)), jcomp.init(to_j(g0))
    _assert_same(_tree_np(res), _np(jres))
    for step in range(3):
        g = _grads(rng, step)
        sent, res = comp(to_t(g), res)
        jsent, jres = jcomp(to_j(g), jres)
        for got, want in ((sent, jsent), (res, jres)):
            _assert_same(_tree_np(got), _np(want))
        for leaf in _flat(sent):
            assert leaf.dtype == torch.float32


def _tree_np(t):
    if isinstance(t, dict):
        return {k: _tree_np(v) for k, v in t.items()}
    return t.numpy()


def _flat(t):
    if isinstance(t, dict):
        return [x for v in t.values() for x in _flat(v)]
    return [t]


@pytest.mark.parametrize("comp", [Int8Compressor(), TopKCompressor(0.25)],
                         ids=["int8", "topk"])
def test_compression_error_feedback_unbiased(comp):
    """Sum of compressed grads ≈ sum of raw grads over many steps (the
    reference's property), and each step conserves g + residual."""
    rng = np.random.RandomState(0)
    grads_seq = [{"w": torch.as_tensor(rng.randn(32, 8), dtype=torch.float32)}
                 for _ in range(40)]
    residual = comp.init(grads_seq[0])
    total_sent = torch.zeros(32, 8)
    total_raw = torch.zeros(32, 8)
    for g in grads_seq:
        before = g["w"] + residual["w"]
        sent, residual = comp(g, residual)
        torch.testing.assert_close(sent["w"] + residual["w"], before,
                                   rtol=0, atol=1e-6)
        total_sent = total_sent + sent["w"]
        total_raw = total_raw + g["w"]
    err = float((total_sent - total_raw).abs().max())
    scale = float(total_raw.abs().max())
    assert err < 0.12 * scale + 0.5     # residual bounded → unbiased sum


def test_int8_and_topk_wire_properties():
    g = {"a": torch.randn(1000, generator=torch.Generator().manual_seed(3))}
    r = Int8Compressor().init(g)
    sent, _ = Int8Compressor()(g, r)
    scale = g["a"].abs().max() / 127.0
    q = sent["a"] / scale
    assert float((q - q.round()).abs().max()) < 1e-3 and \
        float(q.abs().max()) <= 127 + 1e-3
    sent, _ = TopKCompressor(0.1)(g, r)
    nz = sent["a"] != 0
    assert int(nz.sum()) >= 100
    thresh = g["a"].abs().topk(100).values[-1]
    assert bool((g["a"].abs()[nz] >= thresh).all())


def test_train_step_compressor_raises_type_error_in_both_packages():
    """The reference's step calls ``compressor(grads)``; its compressors
    take ``(grads, residual)``.  The port keeps that call (ROADMAP 3b)."""
    rng = np.random.RandomState(0)
    tok = rng.randint(0, 255, (2, 8)).astype(np.int32)
    jcfg = j_all_configs()["gemma3-1b"].reduced()
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    jopt = JAdamW()
    jbatch = {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tok)}
    for comp in (JInt8(), JTopK(0.1)):
        with pytest.raises(TypeError):     # raised while tracing
            jax.jit(j_make_train_step(jm, jopt, comp))(jp, jopt.init(jp),
                                                       jbatch)
    cfg = all_configs()["gemma3-1b"].reduced()
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    opt = AdamW()
    batch = {"tokens": torch.as_tensor(tok), "targets": torch.as_tensor(tok)}
    for comp in (Int8Compressor(), TopKCompressor(0.1)):
        with pytest.raises(TypeError):
            make_train_step(model, opt, comp)(params, opt.init(params),
                                              batch)


# ---------------------------------------------------------------------------
# four gloo ranks: gpipe and restore(shardings=)
# ---------------------------------------------------------------------------
MESHES = {"dm22": ((2, 2), ("data", "model")),
          "pdm221": ((2, 2, 1), ("pod", "data", "model"))}

RANK_SCRIPT = textwrap.dedent("""
    import datetime, json, sys, tempfile, traceback
    from pathlib import Path
    import numpy as np, torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    rank, world, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], Path(sys.argv[4]))
    meshes = json.loads(sys.argv[5])
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    from repro_torch.checkpoint.manager import (CheckpointManager,
                                                flatten_state)
    from repro_torch.configs import all_configs
    from repro_torch.core.layouts import LayoutMode, LayoutParams
    from repro_torch.core.mesh_engine import make_node_mesh
    from repro_torch.distributed.pipeline import gpipe_apply, sequential_ref
    from repro_torch.distributed.sharding import (MeshContext,
                                                  default_rules,
                                                  spec_tree_for)
    from repro_torch.models.param import map_tree
    from repro_torch.models.registry import build_model
    from repro_torch.train.optimizer import AdamW, AdamWState
    got = {}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"] + p["b"])

    try:
        rng = np.random.RandomState(0)
        params = {"w": torch.as_tensor(rng.randn(4, 16, 16) * 0.5,
                                       dtype=torch.float32),
                  "b": torch.as_tensor(rng.randn(4, 16) * 0.1,
                                       dtype=torch.float32)}
        x = torch.as_tensor(rng.randn(6, 8, 16), dtype=torch.float32)
        pp = gpipe_apply(stage_fn, params, x, make_node_mesh(world,
                                                             device="cpu"),
                         n_stages=4)
        ref = sequential_ref(stage_fn, params, x, n_stages=4)
        got["gpipe_equal"] = bool(torch.equal(pp, ref))
        torch.save(pp, out / f"gpipe{rank}.pt")

        cfg = all_configs()["gemma3-1b"].reduced()
        model = build_model(cfg)
        p = model.init(0, device="cpu")
        opt = AdamW()
        g = torch.Generator().manual_seed(5)
        state = (p, AdamWState(torch.tensor(7, dtype=torch.int32),
                               map_tree(lambda t: torch.randn(
                                   t.shape, generator=g), p),
                               map_tree(lambda t: torch.rand(
                                   t.shape, generator=g), p)),
                 torch.tensor([3, 5], dtype=torch.int32))
        axes = (model.param_axes(), opt.state_axes(model.param_axes()),
                (None,))
        abstract = (model.abstract_params(),
                    opt.abstract_state(model.abstract_params()),
                    torch.empty((2,), dtype=torch.int32, device="meta"))
        with tempfile.TemporaryDirectory() as d:
            mgr = CheckpointManager(d, LayoutParams(
                mode=LayoutMode.HYBRID, n_nodes=8), async_save=False,
                device="cpu")
            mgr.save(7, state)
            plain, step = mgr.restore(7, state)
            got["plain_equal"] = step == 7 and all(
                type(a) is torch.Tensor and torch.equal(a, b)
                for (_, a), (_, b) in zip(flatten_state(plain),
                                          flatten_state(state)))
            for name, (shape, names) in meshes.items():
                mesh = init_device_mesh("cpu", tuple(shape),
                                        mesh_dim_names=tuple(names))
                ctx = MeshContext(mesh, default_rules(mesh))
                sh = spec_tree_for(axes, abstract, ctx)
                laid, _ = mgr.restore(7, state, shardings=sh)
                torch.save({k: (t.to_local(), list(s.spec),
                                [str(pl) for pl in t.placements])
                            for (k, t), (_, s) in zip(flatten_state(laid),
                                                      flatten_state(sh))},
                           out / f"{name}_rank{rank}.pt")
        if rank == 0:
            torch.save(dict(flatten_state(state)), out / "state.pt")
        got["ok"] = True
    except Exception:
        got["error"] = traceback.format_exc()
    (out / f"rank{rank}.json").write_text(json.dumps(got))
    dist.destroy_process_group()
""")

REF_SCRIPT = textwrap.dedent("""
    import os
    os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    import json, sys
    sys.path.insert(0, 'src')
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from repro.distributed.pipeline import gpipe_apply
    req = json.loads(open(sys.argv[1]).read())
    mesh = jax.make_mesh((4,), ('stage',))
    def stage_fn(p, x):
        return jnp.tanh(x @ p['w'] + p['b'])
    rng = np.random.RandomState(0)
    params = {'w': jnp.asarray(rng.randn(4, 16, 16) * 0.5, jnp.float32),
              'b': jnp.asarray(rng.randn(4, 16) * 0.1, jnp.float32)}
    x = jnp.asarray(rng.randn(6, 8, 16), jnp.float32)
    out = {'gpipe': np.asarray(gpipe_apply(stage_fn, params, x, mesh,
                                           n_stages=4)).tolist()}
    devs = np.array(jax.devices())
    for name, (shape, names, leaves) in req.items():
        m = Mesh(devs.reshape(shape), tuple(names))
        maps = {}
        for key, (lshape, spec) in leaves.items():
            spec = [tuple(s) if isinstance(s, list) else s for s in spec]
            idx = NamedSharding(m, P(*spec)).devices_indices_map(
                tuple(lshape))
            maps[key] = [[[sl.start or 0, lshape[i] if sl.stop is None
                           else sl.stop] for i, sl in enumerate(idx[d])]
                         for d in devs]
        out[name] = maps
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' outcomes and files, spawned once for the module."""
    tmp = tmp_path_factory.mktemp("ranks4")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT / "src"))
    procs, logs = [], []
    for r in range(4):
        log = open(tmp / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT, str(r), "4",
             str(tmp / "store"), str(tmp), json.dumps(MESHES)],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=GROUP_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    got = []
    for r in range(4):
        f = tmp / f"rank{r}.json"
        got.append(json.loads(f.read_text()) if f.exists() else
                   {"error": (tmp / f"rank{r}.log").read_text()[-4000:]})
    return tmp, got


@pytest.fixture(scope="module")
def reference(ranks, tmp_path_factory):
    """The reference's gpipe output and index maps of the ranks' specs, on
    four host devices in a subprocess."""
    tmp, got = ranks
    assert all(g.get("ok") for g in got), [g.get("error") for g in got]
    req = {}
    for name, (shape, names) in MESHES.items():
        laid = torch.load(tmp / f"{name}_rank0.pt")
        state = torch.load(tmp / "state.pt")
        req[name] = (shape, names, {k: (list(state[k].shape), spec)
                                    for k, (_, spec, _) in laid.items()})
    f = tmp_path_factory.mktemp("ref") / "req.json"
    f.write_text(json.dumps(req))
    r = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(f)],
                       capture_output=True, text=True, cwd=ROOT,
                       timeout=GROUP_TIMEOUT_S,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-4000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_gpipe_matches_sequential_and_reference(ranks, reference):
    tmp, got = ranks
    assert all(g["gpipe_equal"] for g in got)
    outs = [torch.load(tmp / f"gpipe{r}.pt") for r in range(4)]
    assert all(torch.equal(o, outs[0]) for o in outs)
    # float32 products of two libraries: within 1e-5, as the reference's
    # own test holds its pipeline to its sequential oracle
    np.testing.assert_allclose(outs[0].numpy(),
                               np.asarray(reference["gpipe"], np.float32),
                               atol=1e-5, rtol=0)


def test_restore_without_shardings_unchanged(ranks):
    _, got = ranks
    assert all(g["plain_equal"] for g in got)


@pytest.mark.parametrize("name", list(MESHES))
def test_restore_shards_match_reference_index_maps(ranks, reference, name):
    tmp, _ = ranks
    state = torch.load(tmp / "state.pt")
    maps = reference[name]
    two_axis = 0
    for r in range(4):
        laid = torch.load(tmp / f"{name}_rank{r}.pt")
        assert sorted(laid) == sorted(state)
        for key, (local, spec, _) in laid.items():
            sl = tuple(slice(a, b) for a, b in maps[key][r])
            assert torch.equal(local, state[key][sl]), (name, r, key, spec)
            two_axis += any(isinstance(s, (list, tuple)) and len(s) == 2
                            for s in spec)
    if name == "pdm221":
        assert two_axis > 0        # the ("pod", "data") dims were exercised
    sharded = [k for k, (_, spec, _) in torch.load(
        tmp / f"{name}_rank0.pt").items() if any(s for s in spec)]
    assert len(sharded) > 10
