"""Multi-tenant serving of the port against the JAX package, on the CPU in
float32: the adapter pool's behaviours (those of ``test_serve_pool.py``),
``adapter_view`` with the batched dense, the scheduler, and whole
``serve_batch`` runs of reduced StableLM-2-1.6B on the same weights and
adapters, through the pool and through the merged adapter.

Tolerances: projections 1e-6 * sqrt(d_in) of the largest output; logits
2e-5 of the largest logit (2 layers of fp32 sums in other orders).  Greedy
tokens are compared only while the reference's top-2 logit gap exceeds 10x
that tolerance: past a near-tie the two packages may pick different tokens
and their continuations part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import forward as jforward
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.serve import AdapterPool as JPool
from repro.serve import adapter_view as jadapter_view
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch import models
from repro_torch.launch import serve
from repro_torch.models import layers
from repro_torch.serve import AdapterPool, adapter_view, merged_view
from repro_torch.utils.pytree import tree_leaves

ARCH = "stablelm-1.6b"
LOGIT_RTOL = 2e-5


def toy_tree(seed, rank=2, n_layers=3, d=6):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return {"groups": ({"q": {"A": f(n_layers, d, rank), "B": f(n_layers, rank, d)}},),
            "tail": ({"q": {"A": f(d, rank), "B": f(rank, d)}},)}


def toy_template(rank=2):
    return {"groups": ({"q": {"A": torch.zeros(3, 6, rank), "B": torch.zeros(3, rank, 6)}},),
            "tail": ({"q": {"A": torch.zeros(6, rank), "B": torch.zeros(rank, 6)}},)}


def tail_a(tree, slot=None):
    leaf = tree["tail"][0]["q"]["A"]
    return leaf if slot is None else leaf[slot]


class TestPool:
    def test_publish_fills_free_slots_in_order_and_reuses(self):
        pool = AdapterPool(toy_template(), n_slots=3)
        assert [pool.publish(k, toy_tree(i)) for i, k in enumerate("xyz")] == [0, 1, 2]
        assert pool.slot_map() == {"x": 0, "y": 1, "z": 2} and len(pool) == 3
        assert pool.publish("x", toy_tree(9)) == 0 and len(pool) == 3
        assert torch.equal(tail_a(pool.pooled, 0), tail_a(toy_tree(9)))

    def test_publish_writes_in_place(self):
        """The pooled tensors keep their storage across publishes: a holder
        of the pool sees a hot swap with nothing re-created."""
        pool = AdapterPool(toy_template(), n_slots=2)
        ptrs = [x.data_ptr() for x in tree_leaves(pool.pooled)]
        view = pool.view(torch.tensor([0], dtype=torch.int32))
        for i in range(5):
            pool.publish(i % 2, toy_tree(i))
        assert [x.data_ptr() for x in tree_leaves(pool.pooled)] == ptrs
        assert torch.equal(view["groups"][0]["q"]["A"][:, 0], toy_tree(4)["groups"][0]["q"]["A"])
        assert pool.publishes == 5

    def test_empty_slot_is_exact_noop_adapter(self):
        pool = AdapterPool(toy_template(), n_slots=4)
        pool.publish("x", toy_tree(1))
        assert all(float(leaf[1:].abs().max()) == 0.0 for leaf in tree_leaves(pool.pooled))

    @pytest.mark.parametrize("policy,touch,evicted", [
        ("lru", ["old"], "new"),                          # "new" is least recent
        ("traffic", ["old", "old", "old", "new"], "new"),  # "new" has less traffic
    ])
    def test_eviction(self, policy, touch, evicted):
        pool = AdapterPool(toy_template(), n_slots=2, policy=policy)
        pool.publish("old", toy_tree(1))
        pool.publish("new", toy_tree(2))
        pool.acquire(touch)
        pool.publish("third", toy_tree(3))
        assert evicted not in pool and "third" in pool and pool.evictions == 1

    def test_bad_args_and_unknown_ids_raise(self):
        pool = AdapterPool(toy_template(), n_slots=2)
        pool.publish("x", toy_tree(1))
        with pytest.raises(KeyError):
            pool.acquire(["x", "ghost"])
        with pytest.raises(ValueError):
            AdapterPool(toy_template(), n_slots=0)
        with pytest.raises(ValueError):
            AdapterPool(toy_template(), n_slots=2, policy="fifo")
        with pytest.raises(ValueError):
            AdapterPool(toy_template(rank=2), n_slots=2).publish("big", toy_tree(1, rank=4))

    def test_narrow_rank_is_padded_and_serves_identically(self):
        narrow = toy_tree(1, rank=2)
        pool = AdapterPool(toy_template(rank=4), n_slots=2)
        pool.publish("t", narrow)
        got = tail_a(pool.pooled, 0)
        assert torch.equal(got[:, :2], tail_a(narrow)) and float(got[:, 2:].abs().max()) == 0
        x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 6)).astype(np.float32))
        w = torch.eye(6)
        wide = layers.dense(x, {"w": w}, {"A": got, "B": pool.pooled["tail"][0]["q"]["B"][0]})
        want = layers.dense(x, {"w": w}, {"A": tail_a(narrow), "B": narrow["tail"][0]["q"]["B"]})
        torch.testing.assert_close(wide, want, atol=1e-6, rtol=0)

    def test_merged_is_mean_over_resident_only(self):
        pool = AdapterPool(toy_template(), n_slots=4)
        assert float(tail_a(merged_view(pool.pooled, pool.occupancy())).abs().max()) == 0.0
        t1, t2 = toy_tree(1), toy_tree(2)
        pool.publish("x", t1)
        pool.publish("y", t2)
        torch.testing.assert_close(tail_a(pool.merged()), 0.5 * (tail_a(t1) + tail_a(t2)),
                                   atol=1e-6, rtol=0)

    def test_publish_round_applies_update_and_refuses_nan(self):
        pool = AdapterPool(toy_template(), n_slots=2)
        base, update = toy_tree(1), toy_tree(2)
        pool.publish("t", base)
        new = pool.publish_round("t", base, update, lr=0.5)
        want = tail_a(base) + 0.5 * tail_a(update)
        torch.testing.assert_close(tail_a(new), want, atol=1e-6, rtol=0)
        torch.testing.assert_close(tail_a(pool.pooled, 0), want, atol=1e-6, rtol=0)
        bad = toy_tree(3)
        bad["groups"][0]["q"]["B"][1, 0, 0] = float("nan")
        with pytest.raises(ValueError, match="non-finite"):
            pool.publish_round("t", new, bad)
        torch.testing.assert_close(tail_a(pool.pooled, 0), want, atol=1e-6, rtol=0)


class TestScheduler:
    def _sched(self, batch_size=3):
        pool = AdapterPool(toy_template(), n_slots=3)
        for i in range(3):
            pool.publish(f"tenant-{i}", toy_tree(i))
        return pool, serve.RequestScheduler(pool, batch_size)

    def test_submit_unknown_adapter_raises(self):
        _, sched = self._sched()
        with pytest.raises(KeyError):
            sched.submit(serve.Request(0, "ghost", np.zeros(4, np.int32)))

    def test_next_batch_cobatches_across_tenants(self):
        pool, sched = self._sched(batch_size=3)
        for i in range(5):
            sched.submit(serve.Request(i, f"tenant-{i % 3}", np.full(4, i, np.int32)))
        requests, tokens, slots = sched.next_batch()
        assert [r.request_id for r in requests] == [0, 1, 2] and tokens.shape == (3, 4)
        assert slots.tolist() == [pool.slot_map()[f"tenant-{i}"] for i in range(3)]
        assert [r.request_id for r in sched.next_batch()[0]] == [3, 4]
        assert sched.next_batch() is None


@pytest.fixture(scope="module")
def served():
    """Reduced StableLM in both packages on the same weights, and three
    tenant adapters (nonzero B) published in both pools."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    template = jinit_lora(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    trees = [jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32),
                                    template) for _ in range(3)]
    jpool = JPool(template, 4)
    pool = AdapterPool(from_jax_tree(jax.tree_util.tree_map(np.asarray, template)), 4)
    for i, t in enumerate(trees):
        jpool.publish(f"tenant-{i}", jax.tree_util.tree_map(jnp.asarray, t))
        pool.publish(f"tenant-{i}", from_jax_tree(t))
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, jpool=jpool, pool=pool, trees=trees,
                prompts=prompts)


def test_adapter_view_and_batched_dense_match_jax(served):
    pool, jpool = served["pool"], served["jpool"]
    slots = [2, 0, 2, 1]
    view = adapter_view(pool.pooled, torch.tensor(slots, dtype=torch.int32))
    jview = jadapter_view(jpool.pooled, jnp.asarray(slots, jnp.int32))
    a = view["groups"][0]["mixer"]["q"]["A"]
    ja = np.asarray(jview["groups"][0]["mixer"]["q"]["A"])
    np.testing.assert_array_equal(a[:, slots].numpy(), ja)
    assert a.data_ptr() == pool.pooled["groups"][0]["mixer"]["q"]["A"].data_ptr()
    cfg = served["cfg"]
    x = np.random.default_rng(3).normal(size=(4, 5, cfg.d_model)).astype(np.float32)
    w = served["model"].layers[1].mixer["q"]["w"]
    layer = {k: (v if k == "slots" else v[1]) for k, v in view["groups"][0]["mixer"]["q"].items()}
    got = layers.dense(torch.from_numpy(x), {"w": w}, layer, cfg.lora.scale)
    jl = {k: v[1] for k, v in jview["groups"][0]["mixer"]["q"].items()}
    want = np.asarray(jlayers.dense(jnp.asarray(x), {"w": jnp.asarray(w.numpy())}, jl,
                                    cfg.lora.scale))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.sqrt(cfg.d_model) * np.abs(want).max())


def recorder(fn, out):
    def wrapped(*args):
        logits, caches = fn(*args)
        out.append(np.asarray(logits, np.float32) if not torch.is_tensor(logits)
                   else logits.numpy())
        return logits, caches
    return wrapped


def assert_greedy_agrees(got_tokens, want_logits, tol):
    """Tokens equal to the reference's argmax at every step of a request
    until the reference's top-2 gap is within 10x the tolerance."""
    checked = 0
    for row in range(got_tokens.shape[0]):
        for step, logits in enumerate(want_logits):
            top2 = np.sort(logits[row, -1])[-2:]
            if top2[1] - top2[0] <= 10 * tol:
                break
            assert got_tokens[row, step] == np.argmax(logits[row, -1]), (row, step)
            checked += 1
    assert checked >= got_tokens.size // 2, checked


@pytest.mark.parametrize("path", ["pool", "merged"])
def test_serve_matches_jax(served, path):
    """A mixed-tenant batch (tenants 0, 1, 2, 0) through the scheduler and
    the pool, or every request on the merged adapter: prefill logits and
    greedy tokens as the reference's."""
    jcfg, cfg, gen = served["jcfg"], served["cfg"], 4
    prompts = served["prompts"]
    jlogs, tlogs = [], []
    if path == "pool":
        jsched = jserve.RequestScheduler(served["jpool"], 4)
        tsched = serve.RequestScheduler(served["pool"], 4)
        for i in range(4):
            jsched.submit(jserve.Request(i, f"tenant-{i % 3}", prompts[i]))
            tsched.submit(serve.Request(i, f"tenant-{i % 3}", prompts[i]))
        jpre, jdec = jserve.make_serving_fns(jcfg)
        tpre, tdec = serve.make_serving_fns(cfg)
        jserve.serve_batch(served["jp"], served["jpool"], jsched, jcfg, gen=gen,
                           rng=np.random.default_rng(0), prefill_fn=recorder(jpre, jlogs),
                           decode_fn=recorder(jdec, jlogs))
        _, tokens = serve.serve_batch(served["model"], served["pool"], tsched, cfg, gen=gen,
                                      prefill_fn=recorder(tpre, tlogs),
                                      decode_fn=recorder(tdec, tlogs))
    else:
        jl = served["jpool"].merged()
        logits, caches, _ = jforward(served["jp"], jl, {"tokens": jnp.asarray(prompts)}, jcfg,
                                     mode="prefill", remat=False)
        caches = jextend(caches, gen, jcfg)
        jlogs.append(np.asarray(logits))
        for i in range(gen - 1):
            tok = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            logits, caches = jdecode(served["jp"], jl, tok, caches, jnp.asarray(12 + i), jcfg)
            jlogs.append(np.asarray(logits))
        tl = served["pool"].merged()
        tlogs.append(models.forward(served["model"], tl, {"tokens": torch.as_tensor(prompts)},
                                   cfg, mode="prefill")[0].numpy())
        tokens = serve.serve_merged(served["model"], tl, torch.as_tensor(prompts).long(), cfg,
                                    gen=gen)
    tol = LOGIT_RTOL * float(np.abs(jlogs[0]).max())
    np.testing.assert_allclose(tlogs[0], jlogs[0], atol=tol, rtol=0)
    assert tokens.shape == (4, gen)
    assert_greedy_agrees(tokens.numpy(), jlogs, tol)


def test_pool_tenants_differ_from_merged(served):
    cfg, pool = served["cfg"], served["pool"]
    toks = {"tokens": torch.as_tensor(served["prompts"]).long()}
    pre, _ = serve.make_serving_fns(cfg)
    per_tenant, _ = pre(served["model"], pool.pooled,
                        pool.acquire([f"tenant-{i % 3}" for i in range(4)]), toks)
    merged = models.forward(served["model"], pool.merged(), toks, cfg, mode="prefill")[0]
    assert all(float((per_tenant[i] - merged[i]).abs().max()) > 1e-3 for i in range(4))
    # Requests 0 and 3 name one tenant and carry different prompts, same adapter.
    one, _ = pre(served["model"], pool.pooled, pool.acquire(["tenant-0"] * 4), toks)
    torch.testing.assert_close(one[0], per_tenant[0], atol=0, rtol=0)


@pytest.mark.parametrize("merged", [False, True])
def test_main_serves_on_the_cpu(merged):
    argv = ["--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "8", "--gen", "3",
            "--n-adapters", "2", "--pool-slots", "4"] + (["--merged"] if merged else [])
    out = serve.main(argv)
    assert out.shape == (3, 3) and out.device.type == "cpu"


def test_main_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--reduced"])
