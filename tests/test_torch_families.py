"""Every architecture family of the port (`repro_torch.configs`,
`repro_torch.nn.model`, `repro_torch.launch.serve`) against the JAX
package, on the CPU: the ten configs, their param specs and counts, the
dtype each param is stored in, the decode caches, whole models at the
smoke configs, and the serving CLI.

Inputs are drawn with numpy from fixed seeds; the reference's params are
carried over with `params_from_numpy` (every f32 leaf perturbed).
Tolerances:

* Configs (every field of FULL and SMOKE), param specs (shapes, axes,
  init, scale: from the specs alone, never allocated), `n_params()`,
  `n_active_params()`, cache shapes, dtypes and lengths: exactly equal.
* `storage_dtype` of every leaf of all ten configs: exactly the dtype in
  which the reference's prefill reads it, found from its jaxpr (f32 if
  any use reads the f32 value, bf16 if every use first converts it to
  bf16), except ``D``, which the reference converts to bf16 at its one
  use and the port keeps f32 (the same value either way).
* Whole models (prefill logits, every float leaf of the primed caches,
  then 4 teacher-forced decode steps' logits): ``0.08 · max|ref|``, the
  bound of the JAX package's own decode check (``tests/test_archs.py``),
  at the seven smoke configs the port did not serve before and two
  variants: recurrentgemma at 7 layers (2 stacked periods + 1 tail) and
  a 20-token prompt past its window of 16 (the ring wraps in prefill and
  decode).  A recurrentgemma decode step on the ring's first lap (12
  prompt tokens, 16 slots) is held to the reference's teacher-forced
  prefill of the same tokens at the same bound: there the reference's
  own decode attends to ring slots never written, which the port does
  not (ROADMAP "Reference notes").
"""

import dataclasses

import jax
import jax.numpy as jnp
from jax.extend import core as jex_core
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.nn import layers as JL
from repro.nn import model as JM
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import serve
from repro_torch.nn import layers as L
from repro_torch.nn import model as M
from test_torch_lm import DECODE_TOL, f32

torch.set_num_threads(1)
NEW_ARCHS = ("deepseek-v2-236b", "dbrx-132b", "pixtral-12b", "minicpm-2b",
             "recurrentgemma-2b", "seamless-m4t-large-v2", "mamba2-1.3b")


def test_arch_ids_match_jax():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert set(NEW_ARCHS) < set(configs.ARCH_IDS)


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_match_jax(arch):
    for get, jget in ((configs.get, jconfigs.get),
                      (configs.get_smoke, jconfigs.get_smoke)):
        cfg, jcfg = get(arch), jget(arch)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert cfg.hd == jcfg.hd
        assert cfg.attn_free == jcfg.attn_free
        assert cfg.sub_quadratic == jcfg.sub_quadratic


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_param_specs_and_counts_match_jax(arch):
    for cfg, jcfg in ((configs.get(arch), jconfigs.get(arch)),
                      (configs.get_smoke(arch), jconfigs.get_smoke(arch))):
        got, ref = M.param_specs(cfg), JM.param_specs(jcfg)
        assert {k: (v.shape, v.axes, v.init, v.scale)
                for k, v in got.items()} == \
            {k: (v.shape, v.axes, v.init, v.scale) for k, v in ref.items()}
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_active_params() == jcfg.n_active_params()
        for path in got:
            assert (M.active_param_fraction(cfg, path)
                    == JM.active_param_fraction(jcfg, path))


# ---- the dtype the reference reads each param in ---------------------------------

_PASS = {"reshape", "squeeze", "broadcast_in_dim", "slice", "dynamic_slice",
         "gather", "transpose", "expand_dims", "copy"}


def _sub_jaxprs(eqn):
    out = []
    for v in eqn.params.values():
        for j in (v if isinstance(v, (list, tuple)) else [v]):
            j = getattr(j, "jaxpr", j) if hasattr(j, "consts") else j
            if hasattr(j, "eqns") and hasattr(j, "invars"):
                out.append(j)
    return out


def _walk(jaxpr, tracked, reads):
    """Follow each param through the jaxpr: a conversion to bf16 is a
    bf16 read, any other use of the f32 value an f32 read; reshapes,
    slices and gathers carry the param on, and sub-jaxprs (jit, scan)
    are entered at the matching input and left at the matching output."""
    for eqn in jaxpr.eqns:
        for pos, v in enumerate(eqn.invars):
            if isinstance(v, jex_core.Literal) or v not in tracked:
                continue
            name, prim = tracked[v], eqn.primitive.name
            subs = _sub_jaxprs(eqn)
            if prim == "convert_element_type":
                if eqn.params["new_dtype"] == jnp.bfloat16:
                    reads[name].add("bf16")
                else:
                    tracked[eqn.outvars[0]] = name
            elif prim in _PASS and pos == 0:
                tracked[eqn.outvars[0]] = name
            elif subs:
                for sj in subs:
                    inner_pos = pos - (len(eqn.invars) - len(sj.invars))
                    assert 0 <= inner_pos < len(sj.invars), prim
                    inner = {sj.invars[inner_pos]: name}
                    _walk(sj, inner, reads)
                    if len(sj.outvars) == len(eqn.outvars):
                        for o, io in zip(eqn.outvars, sj.outvars):
                            if io in inner:
                                tracked[o] = name
            else:
                reads[name].add("f32")


def reference_reads(jcfg):
    """{param path: {"bf16", "f32"}}: how the reference's prefill reads
    each param (traced abstractly: nothing is allocated)."""
    specs = JM.param_specs(jcfg)
    params = {k: jax.ShapeDtypeStruct(v.shape, jnp.float32)
              for k, v in specs.items()}
    B = 2
    batch = {"tokens": jnp.zeros((B, 10), jnp.int32)}
    stub = (B, jcfg.frontend_tokens, jcfg.d_model)
    if jcfg.frontend == "vit_stub":
        batch["patch_embeds"] = jnp.zeros(stub, jnp.bfloat16)
    if jcfg.encdec is not None:
        batch["frames"] = jnp.zeros(stub)
    closed = jax.make_jaxpr(lambda p: JM.forward_prefill(
        p, jcfg, batch, smax=32, chunks=(8, 8)))(params)
    names = sorted(params)                  # the dict's flattening order
    reads = {n: set() for n in names}
    _walk(closed.jaxpr, dict(zip(closed.jaxpr.invars, names)), reads)
    return reads


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_storage_dtype_is_the_reference_read_dtype(arch):
    reads = reference_reads(jconfigs.get_smoke(arch))
    by_leaf = {}
    for path, r in reads.items():
        assert r, f"{path}: no use found in the reference's prefill"
        by_leaf.setdefault(path.rsplit("/", 1)[-1], set()).update(r)
    for cfg in (configs.get(arch), configs.get_smoke(arch)):
        for path in M.param_specs(cfg):
            leaf = path.rsplit("/", 1)[-1]
            want = (torch.float32 if "f32" in by_leaf[leaf] or leaf == "D"
                    else torch.bfloat16)
            assert L.storage_dtype(path) == want, (path, by_leaf[leaf])
    if arch == "mamba2-1.3b":
        assert by_leaf["D"] == {"bf16"}


def test_f32_leaves_are_stored_f32():
    for leaf in ("router", "dt_bias", "A_log", "D", "conv_w", "w_a", "w_x",
                 "b_a", "b_x", "a_param"):
        assert L.storage_dtype(f"blocks/x/{leaf}") == torch.float32
    cfg = configs.get_smoke("recurrentgemma-2b")
    p = L.init_params(M.param_specs(cfg), torch.Generator().manual_seed(0),
                      "cpu")
    assert p["periods/sub0_rec/rec/w_a"].dtype == torch.float32
    assert p["periods/sub0_rec/rec/w_in"].dtype == torch.bfloat16
    assert p["periods/sub0_rec/rec/a_param"].eq(1).all()


# ---- caches ---------------------------------------------------------------------

def flat_cache(c, path=""):
    """[(path, leaf)] of a cache: dicts by key, cache tuples by field."""
    if isinstance(c, dict):
        return [x for k in sorted(c) for x in flat_cache(c[k],
                                                         f"{path}/{k}")]
    if hasattr(c, "_fields"):
        return [x for f in c._fields for x in flat_cache(getattr(c, f),
                                                         f"{path}.{f}")]
    return [(path, c)]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_init_cache_matches_jax(arch):
    cfg, jcfg = configs.get_smoke(arch), jconfigs.get_smoke(arch)
    got = flat_cache(M.init_cache(cfg, 2, 24))
    ref = flat_cache(JM.init_cache(jcfg, 2, 24))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, g), (_, r) in zip(got, ref):
        assert tuple(g.shape) == tuple(r.shape), path
        assert str(g.dtype).split(".")[-1] == str(r.dtype), path
        assert not g.any()


# ---- whole models against the reference --------------------------------------------

def stacked_periods(cfg):
    return dataclasses.replace(cfg, n_layers=7)


MODEL_CASES = {arch: (arch, None, 12) for arch in NEW_ARCHS}
MODEL_CASES["recurrentgemma 7 layers"] = ("recurrentgemma-2b",
                                          stacked_periods, 12)
MODEL_CASES["recurrentgemma ring wrap"] = ("recurrentgemma-2b", None, 20)


def model_batch(cfg, rng, B, S):
    """Prompt tokens and the stub inputs (``patch_embeds`` in bf16,
    ``frames``) from the serving CLI's numpy draw, for both packages."""
    tb = serve.stub_batch(cfg, rng, B, S, "cpu")
    jb = {k: jnp.asarray(v.float().numpy(), jnp.bfloat16)
          if k == "patch_embeds" else jnp.asarray(v.numpy())
          for k, v in tb.items()}
    return jb, tb


def carried_params(jcfg, seed=0):
    """The reference's params for `jcfg` (numpy), every f32 leaf
    perturbed (as `test_torch_lm.jax_params`)."""
    p = JL.init_params(JM.param_specs(jcfg), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        a = np.array(v)
        if L.storage_dtype(k) == torch.float32:
            a = (a + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        out[k] = a
    return out


# the reference's forwards, compiled once per config and shape (its eager
# op-by-op dispatch takes tens of seconds per model)
jax_prefill = jax.jit(JM.forward_prefill,
                      static_argnames=("cfg", "smax", "chunks"))
jax_decode = jax.jit(JM.forward_decode, static_argnames=("cfg", "chunks"))


@pytest.fixture(scope="module", params=list(MODEL_CASES))
def model_run(request):
    """The reference and the port on one case: prefill, then 4
    teacher-forced decode steps; every output kept."""
    arch, variant, S = MODEL_CASES[request.param]
    jcfg, cfg = jconfigs.get_smoke(arch), configs.get_smoke(arch)
    if variant is not None:
        jcfg, cfg = variant(jcfg), variant(cfg)
    npp = carried_params(jcfg)
    jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = L.params_from_numpy(npp, "cpu")
    rng = np.random.default_rng(11)
    B, smax = 2, S + cfg.frontend_tokens * (cfg.frontend == "vit_stub") + 8
    jb, tb = model_batch(cfg, rng, B, S)
    jl, jc = jax_prefill(jp, cfg=jcfg, batch=jb, smax=smax, chunks=(8, 8))
    before = flash_attention.launches
    tl, tc = M.forward_prefill(tp, cfg, tb, smax=smax)
    assert flash_attention.launches == before       # the CPU: plain version
    prefill = (f32(jl), tl.numpy(), flat_cache(jc),
               [(p, t.clone()) for p, t in flat_cache(tc)])
    steps, seen = [], jb["tokens"]
    for _ in range(4):
        nt = rng.integers(0, cfg.vocab, (B, 1))
        first_lap = cfg.rglru is not None and (
            seen.shape[1] + 1 < min(cfg.rglru.window, smax))
        seen = jnp.concatenate([seen, jnp.asarray(nt, seen.dtype)], 1)
        jl, jc = jax_decode(jp, cfg=jcfg, tokens=jnp.asarray(nt), caches=jc,
                            chunks=(1, 8))
        if first_lap:
            jl, _ = jax_prefill(jp, cfg=jcfg, batch={"tokens": seen},
                                smax=smax, chunks=(8, 8))
        tl, tc = M.forward_decode(tp, cfg, torch.from_numpy(nt), tc,
                                  chunks=(1, 8))
        steps.append((f32(jl), tl.numpy()))
    return cfg, jcfg, prefill, steps, (jc, tc)


def within_bound(got, ref):
    return np.abs(got - ref).max() < DECODE_TOL * np.abs(ref).max()


def assert_lengths_equal(gc, rc):
    lengths = [(p, g) for p, g in gc if p.endswith(".length")]
    assert lengths
    for path, g in lengths:
        assert g.tolist() == np.asarray(dict(rc)[path]).tolist(), path


def test_prefill_matches_jax(model_run):
    cfg, _, (ref, got, rc, gc), _, _ = model_run
    assert got.dtype == np.float32 and got.shape == (2, cfg.vocab)
    assert within_bound(got, ref)
    assert [p for p, _ in gc] == [p for p, _ in rc]
    for (path, g), (_, r) in zip(gc, rc):
        assert tuple(g.shape) == tuple(r.shape), path
        assert str(g.dtype) == f"torch.{r.dtype}", path
        if not path.endswith(".length"):
            assert within_bound(f32(g), f32(r)), path
    assert_lengths_equal(gc, rc)


def test_decode_steps_match_jax(model_run):
    cfg, jcfg, _, steps, (jc, tc) = model_run
    for ref, got in steps:
        assert within_bound(got, ref)
    assert_lengths_equal(flat_cache(tc), flat_cache(jc))
    if cfg.encdec is None:
        assert (int(M._cache_length(cfg, tc))
                == int(JM._cache_length(jcfg, jc)))


# ---- the serving CLI ---------------------------------------------------------------

@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_serve_cli_runs_every_arch_on_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--gen", "3", "--batch", "2"])
    out = capsys.readouterr().out
    name = configs.get_smoke(arch).name
    assert f"arch={name} device=cpu generated (2, 3)" in out
    assert "flash_attention launches 0" in out


def test_serve_cli_caches_hold_the_patch_prefix(monkeypatch, capsys):
    """The ViT stub's patches stand in front of the text in the decode
    cache: a pixtral smoke variant whose patches outnumber the generated
    tokens and the slack serves through the CLI."""
    smoke = configs.get_smoke("pixtral-12b")
    wide = dataclasses.replace(smoke, frontend_tokens=32)
    monkeypatch.setattr(configs, "get_smoke", lambda arch: wide)
    assert wide.frontend_tokens > 3 + 8
    assert serve.serve_smax(wide, 8, 3) == 32 + 8 + 3 + 8
    serve.main(["--arch", "pixtral-12b", "--smoke", "--device", "cpu",
                "--prompt-len", "8", "--gen", "3", "--batch", "2"])
    assert "generated (2, 3)" in capsys.readouterr().out


def test_prefill_longer_than_the_cache_raises():
    kv = torch.zeros(2, 12, 1, 4)
    assert M._pad_prefix(kv, 16).shape == (2, 16, 1, 4)
    with pytest.raises(ValueError, match="does not fit"):
        M._pad_prefix(kv, 11)
