"""Tensor-parallel decoding and serving of the port (the ``kv_cache``
branch of ``TensorParallelAttention``, TP ``generate``, the TP engine of
``chainermn_torch/serving/engine.py`` and its leader/follower channel)
against the JAX package's on the same seeded inputs and weights.

The port runs as two gloo CPU ranks, started once for the module (rank 0
leads every engine, rank 1 follows); the JAX side runs ``generate(...,
comm=)`` and ``paged_attend`` inside ``shard_map`` over two of the eight
virtual CPU devices, JAX at ``highest`` precision. The model is the
reference tests' (``tests/serving_tests/test_engine.py:172-214``,
``test_paged_kv.py:320-345``, ``test_speculative.py:427``): vocab 32,
d_model 16, 8 heads, 2 layers, f32, so a rank holds 4 heads.

- the plain B4 on a head-sharded store (f32 and int8): each rank's local
  heads, concatenated, equal JAX ``paged_attend`` under ``P(None, None,
  axis)`` (``test_paged_kernel.py:219-239``) to 5e-6;
- TP ``generate``, plain and vocab-parallel head: token-exact, logits to
  1e-5;
- the TP engine through ``FCFSScheduler`` (dense, dense with buckets and
  the prefix cache, paged, paged speculative): token-exact against JAX TP
  ``generate``, a same-prefix follower hitting the head-sharded store,
  compile counts flat;
- the TP engine declines migration and sharing, ``capture=True`` raises,
  sampled streams come from the leader's draws, and a deadline shed and
  brownout decided on the leader never split the ranks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu.communicators import MeshCommunicator as JaxMesh
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.parallel import make_3d_mesh as jax_3d_mesh
from chainermn_tpu.parallel.paged_kernel import paged_attend as jax_attend
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.parallel.tensor import reshard_tp_qkv
from chainermn_torch.serving import FCFSScheduler, ServingEngine
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")

N_TP = 2
CFG = dict(vocab_size=32, d_model=16, n_heads=8, n_layers=2, max_len=32)
GEN_PROMPT = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
REQS = {"r1": ([1, 2, 3], 5), "r2": ([4, 5, 6, 7], 4), "r3": ([1, 2, 9], 5)}
B4 = dict(b=2, h=8, d=8, bs=4, n_max=3, lengths=[3, 10], s=2)
SAMPLED = dict(temperature=0.8, seeds=(11, 12))


def _b4_inputs():
    rng = np.random.default_rng(0)
    c = B4
    n = 1 + c["b"] * c["n_max"]
    out = {"k": rng.standard_normal((n, c["bs"], c["h"], c["d"]),
                                    dtype=np.float32),
           "v": rng.standard_normal((n, c["bs"], c["h"], c["d"]),
                                    dtype=np.float32),
           "q": rng.standard_normal((c["b"], c["s"], c["h"], c["d"]),
                                    dtype=np.float32),
           "table": (1 + np.arange(c["b"] * c["n_max"], dtype=np.int32)
                     ).reshape(c["b"], c["n_max"]),
           "lengths": np.asarray(c["lengths"], np.int32)}
    for kk in ("k", "v"):      # the int8 store with its per-row scales
        sc = np.maximum(np.abs(out[kk]).max(-1) / 127.0, 1e-8)
        out[kk + "8"] = np.clip(np.round(out[kk] / sc[..., None]), -127,
                                127).astype(np.int8)
        out[kk + "_scale"] = sc.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_side():
    comm = JaxMesh(mesh=jax_3d_mesh(devices=jax.devices()[:N_TP],
                                    shape=(1, 1, N_TP)))
    out = {"b4_in": _b4_inputs()}
    x = out["b4_in"]
    hs = P(None, None, "tp")
    with jax.default_matmul_precision("highest"):
        f = jax.jit(comm.shard_map(
            lambda q, k, v, t, ln: jax_attend(q, k, v, t, ln),
            in_specs=(hs, hs, hs, P(), P()), out_specs=hs))
        out["b4_f32"] = np.asarray(f(x["q"], x["k"], x["v"], x["table"],
                                     x["lengths"]))
        g = jax.jit(comm.shard_map(
            lambda q, k, v, t, ln, ks, vs: jax_attend(
                q, k, v, t, ln, k_scale=ks, v_scale=vs),
            in_specs=(hs, hs, hs, P(), P(), hs, hs), out_specs=hs))
        out["b4_int8"] = np.asarray(g(x["q"], x["k8"], x["v8"], x["table"],
                                      x["lengths"], x["k_scale"],
                                      x["v_scale"]))
        for vp in (False, True):
            lm = JaxLM(**CFG, tensor_axis="tp", vocab_parallel_head=vp,
                       compute_dtype=jnp.float32)
            params = jax.jit(comm.shard_map(
                lambda t: lm.init(jax.random.PRNGKey(1), t),
                in_specs=P(), out_specs=P()))(GEN_PROMPT)

            def full(p, tok):
                lg = lm.apply(p, tok)
                if vp:
                    lg = jax.lax.all_gather(lg, "tp", axis=-1, tiled=True)
                return lg

            fwd = jax.jit(comm.shard_map(full, in_specs=(P(), P()),
                                         out_specs=P(), check_vma=False))
            rec = {"params": params_from_flax(jax.device_get(params)),
                   "generate": np.asarray(jax_generate(
                       lm, params, GEN_PROMPT, 5, comm=comm)),
                   "logits": np.asarray(fwd(params, GEN_PROMPT))}
            for name, (prompt, n) in REQS.items():
                rec[name] = np.asarray(jax_generate(
                    lm, params, np.asarray([prompt], np.int32), n,
                    comm=comm))[0]
            out[vp] = rec
    return out


_RANKS = """
import numpy as np
import torch
from chainermn_torch import MeshCommunicator, create_communicator
from chainermn_torch.fleet import FleetRouter
from chainermn_torch.models import TransformerLM, generate
from chainermn_torch.models.transformer import gather_vocab
from chainermn_torch.parallel.mesh import make_3d_mesh
from chainermn_torch.parallel.paged_kernel import paged_attend_reference
from chainermn_torch.serving import (FCFSScheduler, ServingEngine,
                                     SpeculativeConfig)
from chainermn_torch.serving.fairness import BrownoutPolicy

torch.set_float32_matmul_precision("highest")
d = torch.load(ARGS[0], weights_only=False)
base = create_communicator("naive", device="cpu")
c = MeshCommunicator(make_3d_mesh(shape=(1, 1, 2)), device="cpu")
r, lead = c.axis_index("tp"), c.axis_index("tp") == 0
res = {"rank": r}

# the plain B4 over this rank's heads of the store
x = {k: torch.from_numpy(v) for k, v in d["b4_in"].items()}
lh = x["q"].shape[2] // 2
mine = lambda t: t[:, :, r * lh:(r + 1) * lh].contiguous()
res["b4_f32"] = paged_attend_reference(mine(x["q"]), mine(x["k"]),
                                       mine(x["v"]), x["table"], x["lengths"])
res["b4_int8"] = paged_attend_reference(
    mine(x["q"]), mine(x["k8"]), mine(x["v8"]), x["table"], x["lengths"],
    k_scale=mine(x["k_scale"]), v_scale=mine(x["v_scale"]))

def model(vp):
    m = TransformerLM(**d["cfg"], tensor_axis="tp", vocab_parallel_head=vp,
                      compute_dtype=torch.float32, device="cpu")
    m.load_state_dict(d["params"][vp])
    return m

prompt = torch.from_numpy(d["gen_prompt"]).long()
for vp in (False, True):
    m = model(vp)
    with torch.no_grad():
        lg = m(prompt)
        res[("logits", vp)] = gather_vocab(lg, c.axis("tp")) if vp else lg
    res[("generate", vp)] = generate(m, prompt, 5, comm=c)

def serve(eng, jobs, *, warm=False, sched_kw=None, follow_up=None):
    # the leader drives, the follower replays; returns what the leader saw
    if not lead:
        return eng.follow()
    if warm:
        eng.warmup()
    sched = FCFSScheduler(eng, **(sched_kw or {}))
    reqs = {n: sched.submit(np.asarray(p), k, **kw)
            for n, (p, k, kw) in jobs.items()}
    sched.run_until_idle()
    out = {n: (q.state.value, [int(t) for t in q.tokens])
           for n, q in reqs.items()}
    if follow_up:
        q = sched.submit(np.asarray(follow_up[1][0]), follow_up[1][1])
        sched.run_until_idle()
        out[follow_up[0]] = (q.state.value, [int(t) for t in q.tokens])
    out["hits"] = (eng.prefix_cache.hits if eng.prefix_cache is not None
                   else 0)
    out["counts"] = eng.compile_counts()
    out["detailed"] = eng.compile_counts_detailed()
    out["recompiles"] = dict(eng.recompiles)
    eng.close()
    return out

reqs = d["reqs"]
two = {n: (reqs[n][0], reqs[n][1], {}) for n in ("r1", "r2")}
kw = dict(comm=c, device="cpu")
res["dense_plain"] = serve(ServingEngine(
    model(False), n_slots=2, prefill_len=8, cache_len=16, paged=False, **kw),
    two)
res["dense_fast"] = serve(ServingEngine(
    model(True), n_slots=2, prefill_len=8, cache_len=16, paged=False,
    prefill_buckets=(4, 8), prefill_batch=2, prefix_cache_blocks=8,
    prefix_block_size=2, **kw), two, warm=True, follow_up=("r3", reqs["r3"]))
res["paged"] = serve(ServingEngine(
    model(False), n_slots=2, prefill_len=8, cache_len=16, paged=True,
    kv_block_size=2, **kw), two, warm=True, follow_up=("r3", reqs["r3"]))
res["spec"] = serve(ServingEngine(
    model(False), n_slots=2, prefill_len=8, cache_len=16, paged=True,
    kv_block_size=2, speculative=SpeculativeConfig(k=2), **kw), two,
    warm=True)
res["sampled"] = serve(ServingEngine(
    model(True), n_slots=2, prefill_len=8, cache_len=16, paged=True,
    kv_block_size=2, temperature=d["sampled"]["temperature"], **kw),
    {n: (reqs[n][0], reqs[n][1], {"seed": s})
     for n, s in zip(("r1", "r2"), d["sampled"]["seeds"])}, warm=True)
# decisions that read the clock are the leader's: a request past its
# deadline is shed, brownout steps, and the follower just replays
policy = BrownoutPolicy(max_level=2, queue_high=0.5, up_after_s=0.0,
                        down_after_s=0.0, cooldown_s=0.0)
res["overload"] = serve(ServingEngine(
    model(False), n_slots=1, prefill_len=8, cache_len=16, paged=True,
    kv_block_size=2, **kw),
    {"late": (reqs["r1"][0], 5, {"deadline_s": 0.0}),
     "a": (reqs["r2"][0], 4, {}), "b": (reqs["r3"][0], 5,
                                        {"priority": "batch"})},
    sched_kw=dict(brownout=policy, fair=True))
if lead:
    res["brownout_steps"] = policy.to_json()["steps"]

eng = ServingEngine(model(False), n_slots=2, prefill_len=8, cache_len=16,
                    paged=True, kv_block_size=2, **kw)
if lead:
    dec = {"migration_supported": eng.migration_supported,
           "export": eng.export_prefix_kv(np.arange(1, 9, dtype=np.int32))}
    dummy = {"n_blocks": 1, "block_size": 2, "kv_quant": "none",
             "n_layers": 2, "tokens": np.asarray([1, 2], np.int32),
             "layers": [{}], "t_start": 0.0}
    dec["can_import"] = eng.can_import_prefix(dummy)
    try:
        eng.import_prefix_kv(dummy)
    except RuntimeError as e:
        dec["import_error"] = str(e)
    router = FleetRouter([eng], share_prefixes=True, autostart=False)
    try:
        dec["router_sharing"] = router.share_prefixes
    finally:
        router.close()
    eng.close()
    res["decline"] = dec
else:
    res["decline"] = eng.follow()
try:
    ServingEngine(model(False), n_slots=2, prefill_len=8, cache_len=16,
                  capture=True, **kw)
except ValueError as e:
    res["capture"] = str(e)
save(res)
c.finalize()
base.finalize()
"""


@pytest.fixture(scope="module")
def port(jax_side, tmp_path_factory):
    payload = {"b4_in": jax_side["b4_in"], "cfg": CFG,
               "gen_prompt": GEN_PROMPT, "reqs": REQS,
               "sampled": SAMPLED,
               "params": {vp: jax_side[vp]["params"] for vp in (False, True)}}
    path = tmp_path_factory.mktemp("tp_serving") / "cases.pt"
    torch.save(payload, path)
    return run_ranks(_RANKS, N_TP, args=[str(path)], timeout=300)


def _lead(port):
    return next(r for r in port if r["rank"] == 0)


@pytest.mark.parametrize("store", ["f32", "int8"])
def test_plain_b4_on_head_sharded_store_matches_jax(port, jax_side, store):
    got = torch.cat([r[f"b4_{store}"] for r in sorted(
        port, key=lambda r: r["rank"])], dim=2)
    np.testing.assert_allclose(got.numpy(), jax_side[f"b4_{store}"],
                               atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("vp", [False, True], ids=["plain", "vocab_parallel"])
def test_tp_generate_matches_jax(port, jax_side, vp):
    want = jax_side[vp]
    for r in port:
        np.testing.assert_array_equal(r[("generate", vp)].numpy(),
                                      want["generate"])
        np.testing.assert_allclose(r[("logits", vp)].numpy(), want["logits"],
                                   atol=1e-5, rtol=1e-5)


def _full(jax_rec, name):
    return [int(t) for t in jax_rec[name][len(REQS[name][0]):]]


@pytest.mark.parametrize("case,vp", [
    ("dense_plain", False), ("dense_fast", True), ("paged", False),
    ("spec", False)])
def test_tp_engine_is_token_exact_against_jax_generate(port, jax_side, case,
                                                       vp):
    got = _lead(port)[case]
    want = jax_side[vp]
    for name in ("r1", "r2", "r3"):
        if name not in got:
            continue
        state, toks = got[name]
        assert state == "done"
        assert toks == _full(want, name), name
    assert got["recompiles"] == {}
    if case == "dense_plain":
        assert got["counts"] == {"prefill": 1, "decode": 1}
    else:
        assert set(got["detailed"].values()) == {1}, got["detailed"]
    if "r3" in got:       # the follower shares the head-sharded blocks
        assert got["hits"] >= 1


def test_followers_replay_every_program(port):
    follower = next(r for r in port if r["rank"] == 1)
    lead = _lead(port)
    for case in ("dense_fast", "paged", "spec"):
        runs = follower[case]
        assert set(runs) == set(lead[case]["detailed"]), case
        assert all(n >= 1 for n in runs.values())
    assert follower["decline"] == {}


def test_sampled_streams_come_from_the_leader(port, jax_side):
    """temperature > 0: the leader draws from each request's generator;
    the streams equal a single-device engine's on the dense twin of the
    same weights with the same seeds."""
    sd = reshard_tp_qkv(dict(jax_side[True]["params"]), CFG["n_heads"],
                        CFG["d_model"] // CFG["n_heads"], N_TP, 1)
    dense = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    dense.load_state_dict({k.replace("attn.", "").replace("mlp.", ""): v
                           for k, v in sd.items()})
    eng = ServingEngine(dense, n_slots=2, prefill_len=8, cache_len=16,
                        paged=True, kv_block_size=2,
                        temperature=SAMPLED["temperature"], device="cpu")
    eng.warmup()
    sched = FCFSScheduler(eng)
    reqs = {n: sched.submit(np.asarray(REQS[n][0]), REQS[n][1], seed=s)
            for n, s in zip(("r1", "r2"), SAMPLED["seeds"])}
    sched.run_until_idle()
    got = _lead(port)["sampled"]
    for n, q in reqs.items():
        assert got[n] == ("done", [int(t) for t in q.tokens])


def test_leader_decisions_never_split_the_ranks(port):
    """The shed and the brownout steps happened on the leader; the ranks
    finished inside ``run_ranks``' timeout, every program replayed."""
    got = _lead(port)["overload"]
    assert got["late"][0] != "done"
    assert got["a"][0] == "done" and len(got["a"][1]) == 4
    assert _lead(port)["brownout_steps"] >= 1
    assert next(r for r in port if r["rank"] == 1)["overload"]["decode"] >= 1


def test_tp_engine_declines_migration_sharing_and_capture(port):
    dec = _lead(port)["decline"]
    assert dec["migration_supported"] is False
    assert dec["export"] is None and dec["can_import"] is False
    assert "single-device" in dec["import_error"]
    assert dec["router_sharing"] is False
    for r in port:
        assert "tensor-parallel" in r["capture"]
