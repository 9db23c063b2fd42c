"""The port's last modules against the JAX package, on the CPU: the config
system (``to_json`` bytes, ``ShapeConfig`` / ``FedConfig`` /
``MeshConfig``), the shapes and their policy (``shape_supported``,
``config_for_shape``, ``input_specs``), the production mesh as data, the
sharding rules leaf by leaf under every policy, the parameter counts of
every full config (the port on ``meta``), the cost model and roofline, the
HLO collective parser, and the one-card dry run (``launch/dryrun.py``) at
reduced sizes, with each sliding-window variant's decode step held to the
reference's.

Tolerances: configs, shapes, specs, counts and the parser are exact; the
cost model's closed forms, given the reference's constants, agree to 1e-12
relative (the same float operations, summed in the same order); the decode
logits of a reduced sliding-window variant to 2e-5 of the largest logit (2
layers of fp32 sums in another order, as ``tests/test_torch_dense.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.launch import costmodel as jcm
from repro.launch import roofline as jrl
from repro.models import decode_step as jdecode
from repro.models import init_decode_caches as jinit_caches
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import partitioning as jpart
from repro_torch import config, configs
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.launch import costmodel as cm
from repro_torch.launch import dryrun, mesh, roofline as rl, steps
from repro_torch.models import init_decode_caches, init_lora_params, init_params
from repro_torch.models import partitioning as part
from repro_torch.utils.pytree import tree_leaves, tree_map_with_path, tree_unflatten

ALL_CONFIGS = (*configs.ARCH_IDS, "paper-vit-b32")
REL = 1e-12
LOGIT_RTOL = 2e-5
# The reference's constants of its CPU container, which the port's cost
# model takes as keyword arguments.
J_SERVE = dict(bw_strided=1.0e4, bw_stream=3.0e4, flops_peak=5.0e4, overhead_per_req=50.0,
               overhead_gathered=250.0)
J_MESH = dict(flops_peak=jcm.MESH_FLOPS_PEAK, bw_hbm=jcm.MESH_BW_HBM, bw_coll=jcm.MESH_BW_COLL,
              coll_overhead_us=jcm.MESH_COLL_OVERHEAD_US, dispatch_us=jcm.MESH_DISPATCH_US)
J_RATES = dict(peak_flops=jrl.PEAK_FLOPS, hbm_bw=jrl.HBM_BW, link_bw=jrl.ICI_BW)


def close(got, want, rel=REL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            close(got[k], want[k], rel)
    elif isinstance(want, (bool, str)) or want is None:
        assert got == want
    else:
        assert abs(got - want) <= rel * abs(want), (got, want)


# --- config system ---------------------------------------------------------

@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_to_json_bytes_and_round_trip(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    data = config.to_json(cfg)
    assert data == jconfig.to_json(jcfg)
    assert config.model_config_from_json(data) == cfg
    assert config.to_json(cfg.reduced()) == jconfig.to_json(jcfg.reduced())


def test_shape_fed_mesh_configs_match():
    for cls in ("ShapeConfig", "FedConfig", "MeshConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(config, cls))]
                == [f.name for f in dataclasses.fields(getattr(jconfig, cls))])
    assert config.to_json(config.FedConfig()) == jconfig.to_json(jconfig.FedConfig())
    for name, shape in configs.SHAPES.items():
        assert config.to_json(shape) == jconfig.to_json(jconfigs.SHAPES[name])
    assert list(configs.SHAPES) == list(jconfigs.SHAPES)
    for multi in (False, True):
        got, want = mesh.make_production_mesh(multi_pod=multi), jconfig.MeshConfig(multi)
        for attr in ("shape", "axes", "n_devices", "client_axes", "n_clients"):
            assert getattr(got, attr) == getattr(want, attr)
        assert mesh.client_axes(got) == want.client_axes


def test_arch_ids_and_all_configs_match():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert ({k: config.to_json(v) for k, v in configs.all_configs().items()}
            == {k: jconfig.to_json(v) for k, v in jconfigs.all_configs().items()})


@pytest.mark.parametrize("n_clients", [None, 16])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shape_policy_and_input_specs_match(arch, n_clients):
    for name, shape in configs.SHAPES.items():
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        jshape = jconfigs.SHAPES[name]
        assert configs.shape_supported(cfg, shape) == jconfigs.shape_supported(jcfg, jshape)
        v, jv = configs.config_for_shape(cfg, shape), jconfigs.config_for_shape(jcfg, jshape)
        assert config.to_json(v) == jconfig.to_json(jv)
        got = configs.input_specs(v, shape, n_clients=n_clients)
        want = jconfigs.input_specs(jv, jshape, n_clients=n_clients)
        assert list(got) == list(want)
        for k in want:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)


# --- sharding rules --------------------------------------------------------

def _norm(spec):
    """A spec with 1-tuples as bare names (PartitionSpec's normal form)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _ref_leaf(tree, name, cfg):
    """The reference's leaf for the port's parameter ``name`` and whether
    it carries the group axis (``convert.model_from_jax``'s mapping)."""
    path = name.split(".")
    unit = len(cfg.layer_pattern)
    n_grouped = cfg.n_pattern_groups * unit
    if path[:2] == ["encoder", "layers"]:
        node, path, stacked = tree["encoder"]["groups"][0], path[3:], True
    elif path[0] == "layers" and int(path[1]) >= n_grouped:
        node, path, stacked = tree["tail"][int(path[1]) - n_grouped], path[2:], False
    elif path[0] == "layers":
        node, path, stacked = tree["groups"][int(path[1]) % unit], path[2:], True
    else:
        node, stacked = tree, False
    for key in path:
        node = node[key]
    return node, stacked


@pytest.mark.parametrize("policy", part.POLICIES)
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_pspecs_match_reference_leaf_by_leaf(arch, policy):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    abstract = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    kw = dict(model_size=16, policy=policy, fsdp_axes=("data",), fsdp_size=16)
    want = jpart.param_pspecs(abstract, **kw)
    model = init_params(cfg, device="meta")
    got = part.param_pspecs(model, cfg, **kw)
    assert list(got) == [n for n, _ in model.named_parameters()]
    for name, p in model.named_parameters():
        spec, stacked = _ref_leaf(want, name, cfg)
        spec = tuple(spec)[1:] if stacked else tuple(spec)
        assert len(got[name]) == p.ndim
        assert _norm(got[name]) == _norm(spec), (name, got[name], spec)


def _at(tree, path):
    for key in path:
        tree = (getattr(tree, key) if hasattr(tree, "_fields") else
                tree[key] if isinstance(tree, dict) else tree[int(key)])
    return tree


def _flat_specs(tensors, specs):
    """(path, spec) of every tensor leaf, the spec looked up in the spec
    tree by the leaf's path (a spec is a tuple, so the walk follows the
    tensors)."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, _norm(_at(specs, path)))), tensors)
    return sorted(out)


def _flat_jspecs(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return sorted((jpart._path_names(p), _norm(tuple(s))) for p, s in flat)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cache_batch_and_lora_pspecs_match(arch):
    for name in ("decode_32k", "long_500k"):
        shape, jshape = configs.SHAPES[name], jconfigs.SHAPES[name]
        jcfg0 = jconfigs.get_config(arch)
        if not jconfigs.shape_supported(jcfg0, jshape):
            continue
        cfg = configs.config_for_shape(configs.get_config(arch), shape)
        jcfg = jconfigs.config_for_shape(jcfg0, jshape)
        b = shape.global_batch
        for axes, n in ((("data",), 16), (("pod", "data"), 32)):
            kw = dict(model_size=16, client_size=n)
            caches = init_decode_caches(cfg, b, shape.seq_len, device="meta")
            got = part.cache_pspecs(caches, cfg, axes, **kw)
            want = jpart.cache_pspecs(
                jax.eval_shape(lambda: jinit_caches(jcfg, b, jshape.seq_len)), jcfg, axes, **kw)
            assert _flat_specs(caches, got) == _flat_jspecs(want)
            specs = configs.input_specs(cfg, shape, n_clients=n)
            jspecs = jconfigs.input_specs(jcfg, jshape, n_clients=n)
            assert (_flat_specs(specs, part.batch_pspecs(specs, axes, n))
                    == _flat_jspecs(jpart.batch_pspecs(jspecs, axes, n)))
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    lora = init_lora_params(cfg, device="meta")
    jlora = jax.eval_shape(lambda k: jinit_lora(k, jcfg), jax.random.PRNGKey(0))
    assert _flat_specs(lora, part.lora_pspecs(lora)) == _flat_jspecs(jpart.lora_pspecs(jlora))
    assert (_flat_specs(lora, part.stacked_lora_pspecs(lora, ("pod", "data")))
            == _flat_jspecs(jpart.stacked_lora_pspecs(jlora, ("pod", "data"))))


def test_bucket_specs_and_padded_cohort_match():
    for d2 in (1, 7, 20, 30, 32, 40):
        for shards in (1, 2, 4, 16):
            assert part.padded_cohort(d2, shards) == jpart.padded_cohort(d2, shards)
    with pytest.raises(ValueError):
        part.padded_cohort(4, 0)
    axes = ("pod", "data")
    assert _norm(part.bucket_pspec(axes)) == _norm(tuple(jpart.bucket_pspec(axes)))
    got, want = part.bucket_carry_pspecs(axes), jpart.bucket_carry_pspecs(axes)
    assert got._fields == want._fields
    for g, w in zip(got, want):
        assert _norm(g) == _norm(tuple(w))


def test_per_device_bytes():
    """Each dim split over its axes' product, rounded up."""
    m = config.MeshConfig(multi_pod=True)
    t = {"a": torch.empty((32, 100), dtype=torch.bfloat16, device="meta"),
         "b": [torch.empty((7,), dtype=torch.float32, device="meta")]}
    specs = {"a": (("pod", "data"), "model"), "b": [("model",)]}
    assert part.per_device_bytes(t, specs, m) == 1 * 7 * 2 + 1 * 4
    assert part.per_device_bytes(t, {"a": (None, None), "b": [(None,)]}, m) == 6400 + 28


# --- counts, roofline, cost model -------------------------------------------

@pytest.mark.parametrize("arch", ALL_CONFIGS)
def test_param_counts_equal_reference(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    base, lora = init_params(cfg, device="meta"), init_lora_params(cfg, device="meta")
    jbase = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    jlora = jax.eval_shape(lambda k: jinit_lora(k, jcfg), jax.random.PRNGKey(0))
    assert rl.count_params(base) == jrl.count_params(jbase)
    assert rl.count_params(lora) == jrl.count_params(jlora)
    assert rl.count_active_params(base, cfg) == jrl.count_active_params(jbase, jcfg)
    for name, shape in configs.SHAPES.items():
        n = rl.count_active_params(base, cfg)
        assert rl.model_flops(cfg, shape, n) == jrl.model_flops(jcfg, jconfigs.SHAPES[name], n)


def test_roofline_terms_and_card_figures():
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.LINK_BW) == (989e12, 3.35e12, 450e9)
    for args in ((1e12, 1e9, 1e8, 256), (1e9, 1e12, 0.0, 1), (1e6, 1e3, 1e12, 512)):
        close(rl.roofline_terms(*args, **J_RATES), jrl.roofline_terms(*args))
    got = rl.roofline_terms(989e12, 3.35e12 * 2, 0.0, 1)
    assert got["compute_s"] == 1.0 and got["memory_s"] == 2.0 and got["dominant"] == "memory"


HLO = [
    ('%ag = bf16[16,128,256]{2,1,0} all-gather(%p), channel_id=1, '
     'replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}'),
    "%ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%add",
    "%a2a = f32[64,32]{1,0} all-to-all(%x), replica_groups=[8,16]<=[128]",
    "%cp = bf16[8,8]{1,0} collective-permute(%x), source_target_pairs={{0,1},{1,0}}",
    "%d = f32[4,4]{1,0} dot(%a, %b)",
]


@pytest.mark.parametrize("i", range(len(HLO) + 1))
def test_parse_collectives_matches_reference(i):
    text = HLO[i] if i < len(HLO) else "\n".join(HLO)
    got, want = rl.parse_collectives(text), jrl.parse_collectives(text)
    assert got.counts == want.counts and got.bytes_by_op == want.bytes_by_op
    assert got.total_bytes == want.total_bytes


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_step_costs_match_reference(arch):
    """Every shape x policy x mesh x aggregator, with and without remat."""
    for name, shape in configs.SHAPES.items():
        cfg = configs.config_for_shape(configs.get_config(arch), shape)
        jcfg = jconfigs.config_for_shape(jconfigs.get_config(arch), jconfigs.SHAPES[name])
        for policy in part.POLICIES:
            for m, c in ((16, 16), (16, 32), (1, 1)):
                for extra in (dict(), dict(aggregator="fedavg", remat=False, local_steps=2),
                              dict(attn_schedule="full_blocks", n_clients=8)):
                    kw = dict(model_size=m, client_shards=c, policy=policy, **extra)
                    got = cm.step_costs(cfg, shape, **kw)
                    want = jcm.step_costs(jcfg, jconfigs.SHAPES[name], **kw)
                    close(got.flops, want.flops)
                    close(got.hbm_bytes, want.hbm_bytes)
                    close(got.collective_bytes, want.collective_bytes)
                    close(got.total_flops, want.total_flops)
        for m in (1, 16):
            for policy in part.POLICIES:
                close(cm._params_local_bytes(cfg, m, 2, policy=policy, fsdp_size=16),
                      jcm._params_local_bytes(jcfg, m, 2, policy=policy, fsdp_size=16))
        close(cm._lora_bytes(cfg, 4), jcm._lora_bytes(jcfg, 4))


def test_serve_gather_costs_match_reference():
    for b in (1, 4, 16, 64):
        for n_ad in (1, 4, 16):
            kw = dict(n_requests=b, seq_len=4, n_adapters=n_ad, d_in=512, d_out=512, rank=16)
            close(cm.serve_gather_costs(**kw, **J_SERVE), jcm.serve_gather_costs(**kw))
    for n_ad in (2, 8, 16, 32):
        assert (cm.serve_crossover_batch(n_adapters=n_ad, **J_SERVE)
                == jcm.serve_crossover_batch(n_adapters=n_ad))
    card = cm.serve_gather_costs(n_requests=8, seq_len=1, n_adapters=4, d_in=2048, d_out=2048,
                                 rank=8)
    assert card["gathered"]["us"] >= cm.KERNEL_CALL_US


def test_mesh_and_uplink_costs_match_reference():
    for cohort in (7, 20, 30, 40):
        for shards in (1, 2, 4, 8):
            for kw in (dict(), dict(warm=False), dict(fused_tail=True, overlap=True),
                       dict(shared_host_core=False, svt_rank=4)):
                args = dict(n_modules=48, padded_vec=4096, cohort=cohort, shards=shards, **kw)
                close(cm.mesh_agg_costs(**args, **J_MESH), jcm.mesh_agg_costs(**args))
        for warm in (True, False):
            kw = dict(n_modules=48, padded_vec=4096, cohort=cohort, warm=warm)
            assert (cm.mesh_crossover_shards(**kw, **J_MESH)
                    == jcm.mesh_crossover_shards(**kw))
        for k in (8, 64):
            kw = dict(n_modules=24, padded_vec=2048, cohort=cohort, k=k, dense_rounds_frac=0.25)
            close(cm.uplink_costs(**kw), jcm.uplink_costs(**kw))
    with pytest.raises(ValueError):
        cm.mesh_agg_costs(n_modules=1, padded_vec=8, cohort=4, shards=0)


# --- the dry run ------------------------------------------------------------

CUT = {"train_4k": config.ShapeConfig("train_4k", 16, 4, "train"),
       "prefill_32k": config.ShapeConfig("prefill_32k", 32, 2, "prefill"),
       "decode_32k": config.ShapeConfig("decode_32k", 64, 2, "decode")}


@pytest.mark.parametrize("arch,shape", [("stablelm-1.6b", "decode_32k"),
                                        ("qwen2-vl-2b", "prefill_32k"),
                                        ("mamba2-130m", "train_4k"),
                                        ("granite-moe-1b-a400m", "train_4k"),
                                        ("whisper-medium", "prefill_32k")])
def test_run_case_card_on_the_cpu(arch, shape):
    """A reduced config at a cut shape runs through the card path on the
    CPU: an ``ok`` record with the reference's keys, counts that equal the
    reference's on the same reduced config, and reckoned bytes."""
    cfg = configs.get_config(arch).reduced()
    rec = dryrun.run_case(arch, shape, arch_cfg=cfg, shape_cfg=CUT[shape], device="cpu")
    assert rec["status"] == "ok", rec.get("trace")
    for key in ("arch", "shape", "mesh", "aggregator", "policy", "microbatch", "tag", "variant",
                "attn_schedule", "analytic", "roofline", "n_params", "n_active_params",
                "model_flops", "useful_flops_ratio", "memory", "step_s"):
        assert key in rec
    assert (rec["aggregator"] is None) == (CUT[shape].kind != "train")
    jcfg = jconfigs.get_config(arch).reduced()
    jbase = jax.eval_shape(lambda k: jinit(k, jcfg), jax.random.PRNGKey(0))
    jlora = jax.eval_shape(lambda k: jinit_lora(k, jcfg), jax.random.PRNGKey(0))
    assert rec["n_params"] == jrl.count_params(jbase) + jrl.count_params(jlora)
    mem = rec["memory"]
    assert mem["reckoned_bytes"] == (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
                                     + mem["temp_size_in_bytes"])
    assert rec["step_s"] > 0 and rec["mfu"] is None


def test_run_case_skips_what_does_not_fit_and_unsupported_shapes():
    rec = dryrun.run_case("gemma-7b", "decode_32k", device="cpu")
    assert rec["status"] == "skipped" and "GiB" in rec["reason"]
    assert rec["memory"]["reckoned_bytes"] > rec["memory"]["budget_bytes"]
    rec = dryrun.run_case("whisper-medium", "long_500k", device="cpu")
    assert rec["status"] == "skipped" and "memory" not in rec


@pytest.mark.parametrize("mesh_name,chips", [("single", 256), ("multi", 512)])
def test_analytic_records_match_the_cost_model(mesh_name, chips):
    """The production-mesh records: the reference's cost model at 16 model
    shards and 16 or 32 client shards, and per-chip argument bytes."""
    for arch, shape in (("deepseek-67b", "train_4k"), ("qwen1.5-32b", "decode_32k"),
                        ("llama4-maverick-400b-a17b", "long_500k")):
        rec = dryrun.run_case(arch, shape, mesh_name, policy="tp_fsdp")
        assert rec["status"] == "analytic", rec.get("trace")
        jshape = jconfigs.SHAPES[shape]
        jcfg = jconfigs.config_for_shape(jconfigs.get_config(arch), jshape)
        want = jcm.step_costs(jcfg, jshape, model_size=16, client_shards=chips // 16,
                              aggregator="fedrpca" if jshape.kind == "train" else "none",
                              policy="tp_fsdp")
        close(rec["analytic"]["flops_per_chip"], want.total_flops)
        close(rec["roofline"], rl.roofline_terms(want.total_flops, want.total_hbm_bytes,
                                                 want.total_collective_bytes, chips))
        assert 0 < rec["memory"]["argument_size_in_bytes"]
    base = init_params(configs.get_config("deepseek-67b"), device="meta")
    full = sum(p.numel() * p.element_size() for p in base.parameters())
    rec = dryrun.run_case("deepseek-67b", "train_4k", mesh_name, policy="tp_fsdp")
    assert rec["memory"]["argument_size_in_bytes"] < full / 100


def test_cli_runs_card_and_analytic_records(tmp_path, capsys):
    code = dryrun.main(["--arch", "deepseek-67b", "--shape", "train_4k", "--mesh", "all",
                        "--device", "cpu", "--out", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert code == 0 and len(out) == 3
    assert out[0].startswith("[skipped ]") and "x card" in out[0]
    assert all(line.startswith("[analytic]") for line in out[1:])
    assert len(list(tmp_path.glob("*.json"))) == 3


def test_cli_refuses_the_card_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        dryrun.main(["--arch", "mamba2-130m", "--shape", "long_500k"])


VARIANTS = [a for a in configs.ARCH_IDS
            if configs.config_for_shape(configs.get_config(a), configs.LONG_500K).layer_pattern
            != configs.get_config(a).layer_pattern]


@pytest.mark.parametrize("arch", VARIANTS)
def test_sliding_window_variant_decode_matches_reference(arch):
    """The long_500k variant (full attention switched to the 4096 window),
    reduced (window 32), decoding at the last position of an 80-position
    context from random caches: the ring slot 79 % 32 and its mask as the
    reference's, through ``make_serve_step``."""
    s, b = 80, 2
    jcfg = jconfigs.config_for_shape(jconfigs.get_config(arch), jconfigs.LONG_500K).reduced()
    cfg = configs.config_for_shape(configs.get_config(arch), configs.LONG_500K).reduced()
    assert config.to_json(cfg) == jconfig.to_json(jcfg) and cfg.window_size == 32
    key = jax.random.PRNGKey(3)
    jbase, jlora = jinit(key, jcfg), jinit_lora(jax.random.fold_in(key, 1), jcfg)
    rng = np.random.default_rng(4)
    jlora = jax.tree_util.tree_map(
        lambda x: x + 0.05 * rng.normal(size=x.shape).astype(np.float32), jlora)
    jcaches = jinit_caches(jcfg, b, s)
    leaves, treedef = jax.tree_util.tree_flatten(jcaches)
    fills = [rng.normal(size=x.shape).astype(np.float32) for x in leaves]
    tokens = rng.integers(0, cfg.vocab_size, size=(b, 1)).astype(np.int32)
    want, _ = jdecode(jbase, jlora, jnp.asarray(tokens), treedef.unflatten(fills), s - 1, jcfg)
    caches = tree_unflatten(init_decode_caches(cfg, b, s, device="cpu"),
                            [torch.from_numpy(f) for f in fills])
    assert [tuple(x.shape) for x in tree_leaves(caches)] == [f.shape for f in fills]
    got, _ = steps.make_serve_step(cfg)(model_from_jax(jbase, cfg), from_jax_tree(jlora),
                                        torch.from_numpy(tokens), caches, s - 1)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=LOGIT_RTOL * float(np.abs(want).max()))
