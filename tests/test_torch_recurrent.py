"""The port's recurrent families against the reference: hymba-1.5b (hybrid
attention + Mamba heads) and xlstm-1.3b (mLSTM / sLSTM), on weights
converted from the reference (`tree_from_numpy`) and inputs made from a
seed with numpy, at the SMOKE sizes (2-4 blocks, d 128).

* configs and registry: field for field, exact answers, `long_500k_mode`
  "native", parameter counts at full size;
* every function of `models/ssm.py` and its decode against the
  reference's, with and without a single adapter;
* chunked (or scanned) forward equals the step-by-step decode, the port's
  own `tests/test_ssm_oracles.py`, Mamba also at S = 300 (where the
  reference asserts S % 256 == 0);
* `forward`, `prefill`, teacher-forced `decode_step` and `cache_spec` of
  both models (hymba's window of 16 rolls its cache);
* training: the scan's backward (`selective_scan_bwd_plain` against
  autograd of the plain scan in f64, rtol = atol = 1e-9; the scan's
  Function against `jax.vjp` of the reference's scan at 2e-4), both
  models' LoRA gradients, and one FLASC round of each through both
  packages' `Experiment` (`tests/_fed_parity.py`'s comparisons);
* `ServingEngine` on both, each request against the reference's
  single-adapter `prefill` and `decode_step` (the reference's own engine
  fails on xLSTM with paged adapters: ROADMAP queue 3 item 5(e)).

Tolerances (f32): rtol = atol = 1e-5 on the matmul paths (mLSTM, sLSTM,
attention; the two packages' CPU matmuls round in different places, as
in `test_torch_archs.py`); 2e-4 wherever Mamba's scan is in the path: the
port scans step by step, the reference's `associative_scan` sums in
another order (the reference's own `test_ssm_oracles.py` tolerance);
chunked against stepwise as in that file (Mamba 2e-4; mLSTM atol 3e-4 /
rtol 3e-3; sLSTM 2e-5).  The whole xlstm-smoke model holds to 1e-4: its
recurrences amplify rounding (a relative perturbation of 1.2e-7 on the
embedding table moves its logits by 1.7e-5, where hymba-smoke's move by
5.5e-6), so two correct f32 evaluations differ by more than 1e-5.  Configs, counts, cache shapes exact; served
tokens exact, except past a token where the reference's top-2 logit gap
is below 1e-4 (none at these seeds).
"""
import _torch_threads  # noqa: F401  (this process's share of the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import lora as jax_lora
from repro.models import model as JM
from repro.models import ssm as JS
from repro.models.config import LoRAConfig as JLoRAConfig
from repro_torch import serving as TSV
from repro_torch.checkpoint.io import tree_from_numpy
from repro_torch.configs import registry as TR
from repro_torch.kernels import selective_scan as sscan
from repro_torch.models import layers as TL
from repro_torch.models import lora as torch_lora
from repro_torch.models import model as TM
from repro_torch.models import ssm as TS
from repro_torch.models.config import LoRAConfig, ModelConfig

ARCHS = ("hymba-1.5b", "xlstm-1.3b")
TOL = dict(rtol=1e-5, atol=1e-5)
SSM_TOL = dict(rtol=2e-4, atol=2e-4)
XLSTM_TOL = dict(rtol=1e-4, atol=1e-4)
GAP = 1e-4
LCFG = JLoRAConfig(rank=4, alpha=8, dtype="float32")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               **tol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(a):
    return tree_from_numpy(jax.tree.map(np.asarray, a), device="cpu")


def _init(spec, seed):
    """numpy draws for a reference spec tree, at the reference's init
    scales (`layers.init_param`: normal / sqrt(fan_in), embed 0.02, zeros,
    ones)."""
    rng = np.random.default_rng(seed)

    def draw(p):
        if p.init in ("zeros", "ones"):
            return np.full(p.shape, p.init == "ones", np.float32)
        fan_in = p.fan_in or (p.shape[-2] if len(p.shape) >= 2
                              else p.shape[-1])
        std = 0.02 if p.init == "embed" else 1 / np.sqrt(max(fan_in, 1))
        return (rng.standard_normal(p.shape) * std).astype(np.float32)
    return jax.tree.map(draw, spec, is_leaf=lambda p: isinstance(p, JL.P))


def _perturbed(spec, seed, scale=0.2):
    """Random params with the zero- and one-initialised leaves (A_log,
    dt_bias, D_skip, conv_b, b_if, b, the norms, w_comb) moved off their
    init, so that every weight is exercised."""
    rng = np.random.default_rng(seed)

    def move(x):
        if np.all(x == x.flat[0]):
            return (x + scale * rng.standard_normal(x.shape)).astype(x.dtype)
        return x
    return jax.tree.map(move, _init(spec, seed))


def _tcfg(cfg):
    return ModelConfig(**dataclasses.asdict(cfg))


def _x(seed, shape, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and registry
# ---------------------------------------------------------------------------

def test_configs_and_registry_match_reference():
    for arch in ARCHS:
        assert arch in TR.ARCH_IDS and arch in JR.ARCH_IDS
        for smoke in (False, True):
            assert dataclasses.asdict(TR.get_config(arch, smoke)) == \
                dataclasses.asdict(JR.get_config(arch, smoke)), (arch, smoke)
        assert TR.long_500k_mode(arch) == JR.long_500k_mode(arch) == "native"
        TM.check_servable(TR.get_config(arch))
    assert [k for k, _ in TR.get_config("hymba-1.5b").layer_groups()] == \
        ["hybrid"]
    assert TR.get_config("xlstm-1.3b").layer_groups() == \
        [("period:" + ",".join(["mlstm"] * 7 + ["slstm"]), 6)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_parameter_counts_and_specs_match_reference(arch, smoke):
    tcfg, jcfg = TR.get_config(arch, smoke), JR.get_config(arch, smoke)
    assert TM.count_params(tcfg) == JM.count_params(jcfg)
    if not smoke:
        # hymba-1.5b 1.64 B, xlstm-1.3b 2.02 B (specs only, no allocation)
        assert TM.count_params(tcfg) == {"hymba-1.5b": 1_641_886_464,
                                         "xlstm-1.3b": 2_020_481_360}[arch]
    tspec, jspec = TM.model_spec(tcfg), JM.model_spec(jcfg)
    tl = TL.map_specs(lambda p: (p.shape, p.dtype, p.init), tspec)
    jl = jax.tree.map(lambda p: (p.shape, p.dtype, p.init), jspec,
                      is_leaf=lambda p: isinstance(p, JL.P))
    assert tl == jl
    lcfg = LoRAConfig(rank=4, alpha=8)
    tls = TL.map_specs(lambda p: (p.shape, p.init),
                       torch_lora.lora_spec(tcfg, lcfg))
    jls = jax.tree.map(lambda p: (p.shape, p.init),
                       jax_lora.lora_spec(jcfg, LCFG),
                       is_leaf=lambda p: isinstance(p, JL.P))
    assert tls == jls
    for n in (1, 3):
        tc = TL.map_specs(lambda p: (p.shape, p.dtype),
                          TM.cache_spec(tcfg, n, 40))
        jc = jax.tree.map(lambda p: (p.shape, p.dtype),
                          JM.cache_spec(jcfg, n, 40),
                          is_leaf=lambda p: isinstance(p, JL.P))
        assert tc == jc


# ---------------------------------------------------------------------------
# the blocks of models/ssm.py
# ---------------------------------------------------------------------------

HYMBA = JR.get_config("hymba-1.5b", smoke=True)
XLSTM = JR.get_config("xlstm-1.3b", smoke=True)


def _core_lora(spec, keys, seed):
    """A single adapter (rank 4) on `keys` of a block's spec, b nonzero."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in keys:
        w = spec[k]
        lead, (d_in, d_out) = w.shape[:-2], w.shape[-2:]
        out[k] = {"a": (rng.standard_normal(lead + (d_in, 4)) /
                        np.sqrt(d_in)).astype(np.float32),
                  "b": (0.1 * rng.standard_normal(lead + (4, d_out))
                        ).astype(np.float32)}
    return out


BLOCKS = {  # name: (spec, forward, decode, init_state, lora targets)
    "mamba": (JS.mamba_spec, "mamba_forward_state", "mamba_decode",
              "mamba_init_state", ("in_proj", "out_proj"), HYMBA),
    "mlstm": (JS.mlstm_spec, "mlstm_forward_state", "mlstm_decode",
              "mlstm_init_state", ("wq", "wk", "wv", "down"), XLSTM),
    "slstm": (JS.slstm_spec, "slstm_forward_state", "slstm_decode",
              "slstm_init_state", ("wx", "down"), XLSTM),
}


@pytest.mark.parametrize("adapter", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_forward_and_decode_match_reference(block, adapter):
    spec_fn, fwd, dec, init, targets, cfg = BLOCKS[block]
    tcfg = _tcfg(cfg)
    spec = spec_fn(cfg)
    params = _perturbed(spec, 11)
    lora = _core_lora(spec, targets, 12) if adapter else None
    tp, tl = _tree(params), (_tree(lora) if adapter else None)
    tol = SSM_TOL if block == "mamba" else TOL
    B, S = 2, 16
    x = _x(13, (B, S, cfg.d_model))
    y_j, st_j = getattr(JS, fwd)(params, jnp.asarray(x), cfg, lora=lora,
                                 ls=1.5)
    with torch.no_grad():
        y_t, st_t = getattr(TS, fwd)(tp, _t(x), tcfg, lora=tl, ls=1.5)
    _close(y_t, y_j, tol)
    assert sorted(st_t) == sorted(st_j)
    for k in st_j:
        _close(st_t[k], st_j[k], tol)
    # three decode steps on from the forward's state
    state_t = dict(st_t)
    state_j = st_j
    for i in range(3):
        x1 = _x(14 + i, (B, 1, cfg.d_model))
        y1_j, state_j = getattr(JS, dec)(params, jnp.asarray(x1), state_j,
                                         cfg, lora=lora, ls=1.5)
        with torch.no_grad():
            y1_t, back = getattr(TS, dec)(tp, _t(x1), state_t, tcfg, lora=tl,
                                          ls=1.5)
        assert back is state_t            # updated in place
        _close(y1_t, y1_j, tol)
        for k in state_j:
            _close(state_t[k], state_j[k], tol)
    want0 = getattr(JS, init)(cfg, 3)
    got0 = getattr(TS, init)(tcfg, 3)
    for k in want0:
        _close(got0[k], want0[k], dict(rtol=0, atol=0))


def test_small_functions_match_reference():
    tcfg = _tcfg(HYMBA)
    assert TS.mamba_inner_dim(tcfg) == JS.mamba_inner_dim(HYMBA) == 256
    assert TS.mlstm_inner(_tcfg(XLSTM)) == JS.mlstm_inner(XLSTM) == (256, 64)
    x = _x(20, (2, 9, 6))
    w, b = _x(21, (4, 6)), _x(22, (6,))
    _close(TS._causal_conv(_t(x), _t(w), _t(b)),
           JS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    u = _x(23, (2, 5, 3, 8))
    wh = _x(24, (3, 8, 8))
    pair = {"a": _x(25, (3, 8, 2)), "b": _x(26, (3, 2, 8))}
    _close(TS._headwise(_t(u), _t(wh)),
           JS._headwise(jnp.asarray(u), jnp.asarray(wh)))
    _close(TS._headwise(_t(u), _t(wh), _tree(pair), 0.7),
           JS._headwise(jnp.asarray(u), jnp.asarray(wh), pair, 0.7))
    # the coefficients the scan forms: decay a, drive bu, readout Cc
    params = _perturbed(JS.mamba_spec(HYMBA), 27)
    uu = _x(28, (2, 7, 256))
    a_j, bu_j, c_j = JS._ssm_coeffs(params, jnp.asarray(uu))
    tp = _tree(params)
    uf, dt, A = sscan.scan_coeffs(_t(uu), tp["w_dt"], tp["dt_bias"],
                                  tp["A_log"])
    Bc, Cc = TS._ssm_coeffs(tp, _t(uu))
    _close(torch.exp(dt[..., None] * A), a_j)
    _close((dt * uf)[..., None] * Bc[..., None, :], bu_j)
    _close(Cc, c_j)
    # one mLSTM chunk from a nonzero carry, and one sLSTM cell
    B, L, H, hd = 2, 5, 3, 4
    q, k, v = (_x(30 + i, (B, L, H, hd)) for i in range(3))
    logf = -np.abs(_x(33, (B, L, H)))
    logi = _x(34, (B, L, H))
    carry = (_x(35, (B, H, hd, hd)), np.abs(_x(36, (B, H, hd))),
             _x(37, (B, H)))
    h_j, c_j2 = JS._mlstm_chunk(*map(jnp.asarray, (q, k, v, logf, logi)),
                                tuple(map(jnp.asarray, carry)))
    h_t, c_t = TS._mlstm_chunk(*map(_t, (q, k, v, logf, logi)),
                               tuple(map(_t, carry)))
    _close(h_t, h_j)
    for g, wnt in zip(c_t, c_j2):
        _close(g, wnt)
    sp = _perturbed(JS.slstm_spec(XLSTM), 38)
    gx = _x(39, (2, 4 * 128))
    st = tuple(_x(40 + i, (2, 4, 32)) for i in range(4))
    want = JS._slstm_cell(sp, jnp.asarray(gx), tuple(map(jnp.asarray, st)),
                          XLSTM)
    got = TS._slstm_cell(_tree(sp), _t(gx), tuple(map(_t, st)), _tcfg(XLSTM))
    for g, wnt in zip(got, want):
        _close(g, wnt)


# ---------------------------------------------------------------------------
# chunked / scanned forward equals the stepwise decode (port only)
# ---------------------------------------------------------------------------

ORACLE = ModelConfig(name="s", family="hybrid", num_layers=1, d_model=32,
                     num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                     vocab_size=64, ssm_state_size=4, ssm_expand=2,
                     mlstm_chunk=4, param_dtype="float32",
                     compute_dtype="float32")


def _stepwise(dec, params, x, state):
    outs = []
    for t in range(x.shape[1]):
        y, state = dec(params, x[:, t:t + 1], state, ORACLE)
        outs.append(y)
    return torch.cat(outs, dim=1), state


@pytest.mark.parametrize("S", [16, 300])
def test_mamba_scan_equals_stepwise(S):
    params = TL.init_params(TS.mamba_spec(ORACLE), 0, device="cpu")
    params["A_log"].add_(torch.linspace(-1, 1, params["A_log"].numel())
                         .reshape(params["A_log"].shape))
    x = _t(_x(1, (2, S, ORACLE.d_model)))
    with torch.no_grad():
        y_par, st_par = TS.mamba_forward_state(params, x, ORACLE)
        y_seq, st = _stepwise(TS.mamba_decode, params, x,
                              TS.mamba_init_state(ORACLE, 2))
    _close(y_par, y_seq, SSM_TOL)
    _close(st_par["h"], st["h"], SSM_TOL)
    _close(st_par["conv"], st["conv"], SSM_TOL)
    assert bool(torch.isfinite(y_par).all())


def test_mlstm_chunked_equals_stepwise_and_chunk_invariant():
    params = TL.init_params(TS.mlstm_spec(ORACLE), 2, device="cpu")
    x = _t(_x(3, (2, 13, ORACLE.d_model)))       # 13: the padded last chunk
    with torch.no_grad():
        y_par, st_par = TS.mlstm_forward_state(params, x, ORACLE)
        y_seq, st = _stepwise(TS.mlstm_decode, params, x,
                              TS.mlstm_init_state(ORACLE, 2))
        tol = dict(atol=3e-4, rtol=3e-3)
        _close(y_par, y_seq, tol)
        _close(st_par["C"], st["C"], tol)
        _close(st_par["m"], st["m"], dict(atol=3e-4, rtol=0))
        x16 = x[:1, :12]
        ys = [TS.mlstm_forward_state(params, x16, dataclasses.replace(
            ORACLE, mlstm_chunk=c))[0] for c in (4, 8, 16)]
    for y in ys[1:]:
        _close(y, ys[0], dict(atol=2e-4, rtol=2e-3))


def test_slstm_forward_equals_stepwise():
    params = TL.init_params(TS.slstm_spec(ORACLE), 4, device="cpu")
    x = _t(_x(5, (2, 10, ORACLE.d_model)))
    with torch.no_grad():
        y_fwd, st_fwd = TS.slstm_forward_state(params, x, ORACLE)
        y_seq, st = _stepwise(TS.slstm_decode, params, x,
                              TS.slstm_init_state(ORACLE, 2))
    _close(y_fwd, y_seq, dict(atol=2e-5, rtol=2e-5))
    _close(st_fwd["c"], st["c"], dict(atol=2e-5, rtol=0))


def test_scan_plain_matches_the_reference_recurrence_and_takes_h0():
    # selective_scan on the CPU (its plain version) from a nonzero h0,
    # against the reference's decode recurrence a h + bu written out
    params = _perturbed(JS.mamba_spec(HYMBA), 50)
    tp = _tree(params)
    u = _x(51, (3, 37, 256))
    h0 = _x(52, (3, 256, 8))
    Bc, Cc = (_x(53 + i, (3, 37, 8)) for i in range(2))
    y, h = sscan.selective_scan(_t(u), tp["w_dt"], tp["dt_bias"],
                                tp["A_log"], tp["D_skip"], _t(Bc), _t(Cc),
                                _t(h0))
    A = -np.exp(params["A_log"].astype(np.float64))
    dt = np.logaddexp(u * params["w_dt"][:, 0] + params["dt_bias"], 0.0)
    hh = h0.astype(np.float64)
    ys = []
    for t in range(37):
        hh = np.exp(dt[:, t, :, None] * A) * hh \
            + (dt[:, t] * u[:, t])[..., None] * Bc[:, t, None, :]
        ys.append(np.einsum("bdn,bn->bd", hh, Cc[:, t]))
    want = np.stack(ys, 1) + params["D_skip"] * u
    _close(y, want, dict(rtol=1e-5, atol=1e-5))
    _close(h, hh, dict(rtol=1e-5, atol=1e-5))
    out = torch.zeros(3, 256, 8)
    _, h2 = sscan.selective_scan(_t(u), tp["w_dt"], tp["dt_bias"],
                                 tp["A_log"], tp["D_skip"], _t(Bc), _t(Cc),
                                 _t(h0), out_state=out)
    assert h2 is out and torch.equal(out, h)
    with pytest.raises(ValueError, match="Bc"):
        sscan.selective_scan(_t(u), tp["w_dt"], tp["dt_bias"], tp["A_log"],
                             tp["D_skip"], _t(Bc[:, :5]), _t(Cc))


# ---------------------------------------------------------------------------
# the scan's backward (the CPU side of csrc/selective_scan.cu's backward)
# ---------------------------------------------------------------------------

def _scan_f64(seed, B, S, di, N):
    """Every input of the scan and h0 in f64 at a trained model's scales,
    and the upstream dy, dh_last."""
    rng = np.random.default_rng(seed)

    def d(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(rng.standard_normal(shape) * scale + shift)
    ins = [d(B, S, di), d(di, 1, scale=di ** -0.5),
           d(di, scale=0.5, shift=-1.0),
           torch.from_numpy(rng.uniform(-4.0, 1.0, (di, N))),
           d(di, scale=0.1, shift=1.0), d(B, S, N), d(B, S, N), d(B, di, N)]
    return ins, d(B, S, di), d(B, di, N)


# f64 on both sides, the same function summed in another order
@pytest.mark.parametrize("N", [8, 16])
@pytest.mark.parametrize("S", [1, 5, 300])
def test_scan_backward_plain_matches_autograd_of_the_plain_scan(S, N):
    ins, dy, dh = _scan_f64(S + N, 2, S, 6, N)
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, h = sscan.selective_scan_plain(*leaves)
    want = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves,
                               retain_graph=True)
    got = sscan.selective_scan_bwd_plain(*ins, dy, dh)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9)
    # no dh_last: the gradient of y alone
    want = torch.autograd.grad((y * dy).sum(), leaves)
    got = sscan.selective_scan_bwd_plain(*ins, dy)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-9,
                                   atol=1e-9)


@pytest.mark.parametrize("h0", [False, True])
def test_scan_gradient_through_the_function_matches_reference_vjp(
        h0, monkeypatch):
    # the port's _scan under autograd (the Function, its plain backward on
    # the CPU) against jax.vjp of the reference's _ssm_coeffs, _chunk_scan
    # and readout, for u and every parameter the scan reads
    params = _perturbed(JS.mamba_spec(HYMBA), 80)
    keys = ("w_B", "w_C", "w_dt", "dt_bias", "A_log", "D_skip")
    sub = {k: params[k] for k in keys}
    di, N = JS.mamba_inner_dim(HYMBA), HYMBA.ssm_state_size
    B, S = 2, 40
    u, dy, dh = _x(81, (B, S, di)), _x(82, (B, S, di)), _x(83, (B, di, N))
    h_init = _x(84, (B, di, N)) if h0 else np.zeros((B, di, N), np.float32)

    def ref(p, u, hi):
        a, bu, Cc = JS._ssm_coeffs(p, u)
        h, h_last = JS._chunk_scan(a, bu, hi)
        y = jnp.einsum("bsdn,bsn->bsd", h, Cc) + p["D_skip"] * u
        return y, h_last
    (yj, hj), vjp = jax.vjp(ref, sub, jnp.asarray(u), jnp.asarray(h_init))
    gp, gu, gh = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    calls = []
    plain = sscan.selective_scan_bwd_plain
    monkeypatch.setattr(sscan, "selective_scan_bwd_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    tp = {k: _t(v).requires_grad_(True) for k, v in sub.items()}
    tu = _t(u).requires_grad_(True)
    th = _t(h_init).requires_grad_(True) if h0 else None
    y, h = TS._scan(tp, tu, h0=th)
    _close(y, yj, SSM_TOL)
    _close(h, hj, SSM_TOL)
    leaves = [tu, *(tp[k] for k in keys)] + ([th] if h0 else [])
    grads = torch.autograd.grad((y * _t(dy)).sum() + (h * _t(dh)).sum(),
                                leaves)
    assert calls == [1]
    _close(grads[0], gu, SSM_TOL)
    for k, g in zip(keys, grads[1:]):
        assert g.shape == tp[k].shape
        _close(g, gp[k], SSM_TOL)
    if h0:
        _close(grads[-1], gh, SSM_TOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

def _weights(cfg, seed):
    params = _perturbed(JM.model_spec(cfg), seed, scale=0.05)
    lora = _init(jax_lora.lora_spec(cfg, LCFG), seed + 1)
    rng = np.random.default_rng(seed)
    lora = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
        x.shape).astype(np.float32), lora)
    return params, lora


def _leaves_close(got, want, tol):
    gl = list(TL.tree_leaves(got))
    wl = jax.tree.leaves(want)   # sorted dict keys, tuples in order
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g, w, tol)


def _run_both(cfg, S, gen, seed):
    params, lora = _weights(cfg, seed)
    tcfg = _tcfg(cfg)
    tol = SSM_TOL if cfg.family == "hybrid" else XLSTM_TOL
    tp, tl = _tree(params), _tree(lora)
    toks = np.random.default_rng(seed + 2).integers(0, cfg.vocab_size, (2, S))
    bj, bt = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    with torch.no_grad():
        out_t = TM.forward(tp, tcfg, bt, lora=tl, lora_scale=LCFG.scale)
    out_j = jax.jit(lambda b: JM.forward(params, cfg, b, lora=lora,
                                         lora_scale=LCFG.scale))(bj)
    _close(out_t["logits"], out_j["logits"], tol)
    lg_j, c_j = jax.jit(lambda b: JM.prefill(
        params, cfg, b, lora=lora, lora_scale=LCFG.scale,
        max_len=S + gen))(bj)
    with torch.no_grad():
        lg_t, c_t = TM.prefill(tp, tcfg, bt, lora=tl, lora_scale=LCFG.scale,
                               max_len=S + gen)
    _close(lg_t, lg_j, tol)
    _leaves_close(c_t, c_j, tol)
    spec = TL.map_specs(lambda p: (p.shape, p.dtype),
                        TM.cache_spec(tcfg, 2, S + gen))
    assert spec == TL.map_specs(lambda p: (p.shape, p.dtype), jax.tree.map(
        lambda a: TL.P(tuple(a.shape), (None,) * a.ndim,
                       dtype=str(a.dtype)), c_j))
    # teacher-forced decode: both packages take the reference's tokens
    step = jax.jit(lambda t, p, c: JM.decode_step(
        params, cfg, t, p, c, lora=lora, lora_scale=LCFG.scale))
    tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)
    # the reference's cache tree (KV tuples, state dicts, period
    # sub-blocks) carried over by tree_from_numpy decodes in the port
    c_ref = tree_from_numpy(jax.tree.map(np.asarray, c_j), device="cpu")
    with torch.no_grad():
        lg_c, _ = TM.decode_step(tp, tcfg, _t(tok), torch.tensor(S), c_ref,
                                 lora=tl, lora_scale=LCFG.scale)
    _close(lg_c, step(jnp.asarray(tok), jnp.int32(S), c_j)[0], tol)
    for i in range(gen):
        lg_j, c_j = step(jnp.asarray(tok), jnp.int32(S + i), c_j)
        with torch.no_grad():
            lg_t, back = TM.decode_step(tp, tcfg, _t(tok), torch.tensor(S + i),
                                        c_t, lora=tl, lora_scale=LCFG.scale)
        assert back is c_t
        _close(lg_t, lg_j, tol)
        tok = np.asarray(jnp.argmax(lg_j[:, -1], -1), np.int32)
    _leaves_close(c_t, c_j, tol)


# hymba-smoke's window is 16: S 16 fills it and decode rolls the cache; at
# 256 and 512 the prompt is longer than the window (the reference's Mamba
# takes these lengths; it asserts at 300)
@pytest.mark.parametrize("S,gen", [(16, 5), (256, 3), (512, 2)])
def test_hymba_forward_prefill_decode_match_reference(S, gen):
    _run_both(HYMBA, S, gen, 60)


@pytest.mark.parametrize("S,gen", [(12, 4), (29, 3)])
def test_xlstm_forward_prefill_decode_match_reference(S, gen):
    _run_both(XLSTM, S, gen, 61)


def _lora_gradient_matches_reference(cfg, S, seed, tol):
    """The LoRA gradient of `loss_fn` on 2 sequences of S tokens against
    jax.grad of the reference's, leaf by leaf."""
    params, lora = _weights(cfg, seed)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (2, S))
    gj = jax.grad(lambda lt: JM.loss_fn(params, cfg,
                                        {"tokens": jnp.asarray(toks)},
                                        lora=lt, lora_scale=LCFG.scale))(lora)
    tl = _tree(lora)
    leaves = list(TL.tree_leaves(tl))
    for t in leaves:
        t.requires_grad_(True)
    loss = TM.loss_fn(_tree(params), _tcfg(cfg), {"tokens": _t(toks)},
                      lora=tl, lora_scale=LCFG.scale)
    grads = torch.autograd.grad(loss, leaves)
    wl = jax.tree.leaves(gj)
    assert len(grads) == len(wl)
    for g, w in zip(grads, wl):
        _close(g, w, tol)


def test_hymba_loss_gradient_matches_reference():
    # the CPU training path: the LoRA gradient through the scan's Function
    # (its plain forward and backward on the CPU; on the card the same
    # Function launches the kernels)
    _lora_gradient_matches_reference(HYMBA, 16, 62, SSM_TOL)


# xLSTM's mLSTM and sLSTM loops are plain PyTorch, differentiated by
# autograd; S 12 and 29 end in a padded mLSTM chunk, 64 spans several
@pytest.mark.parametrize("S", [12, 29, 64])
def test_xlstm_loss_gradient_matches_reference(S):
    _lora_gradient_matches_reference(XLSTM, S, 64, XLSTM_TOL)


# one FLASC round of each family through both packages' task-less
# Experiment: the same converted backbone and LoRA tree, 4 clients x 1 step
# x 4 sequences of 16 tokens, held by tests/_fed_parity.py's compare.  Its
# flat atol is 1e-6 for hymba and 1e-5 for xLSTM: xLSTM's recurrences
# amplify rounding (XLSTM_TOL), so the two packages' client uploads differ
# by up to 3.0e-6 on the entries both keep (hymba's by 5.8e-8), which
# FedAdam's first step g / (|g| + eps) turns into up to 4.3e-6 of an update
@pytest.mark.parametrize("cfg,gap,atol", [(HYMBA, 1e-7, 1e-6),
                                          (XLSTM, 5e-6, 1e-5)],
                         ids=["hymba", "xlstm"])
def test_flasc_round_matches_reference(cfg, gap, atol, monkeypatch):
    from _fed_parity import FED, Run, _keeper, capturing, compare
    from repro.core import strategies as jst
    from repro.federated import api as japi
    from repro.models.config import FederatedConfig as JFederatedConfig
    from repro_torch.core import strategies as tst
    from repro_torch.core.fedround import FlatMeta
    from repro_torch.federated import Experiment
    from repro_torch.federated import engine as teng
    from repro_torch.models.config import FederatedConfig

    params, lora = _weights(cfg, 90)
    monkeypatch.setattr(jax_lora, "init_lora",
                        lambda *a, **k: jax.tree.map(jnp.asarray, lora))
    monkeypatch.setattr(torch_lora, "init_lora",
                        lambda *a, **k: _tree(lora))
    spec = dict(kind="flasc", selector="fused")
    jstrat = capturing(type(jst.resolve(jst.StrategySpec(**spec))), True)(
        jst.StrategySpec(**spec))
    tstrat = capturing(type(tst.resolve(tst.StrategySpec(**spec))), False)(
        tst.StrategySpec(**spec))
    jstrat.kept, tstrat.kept = [], []
    toks = np.random.default_rng(91).integers(
        0, cfg.vocab_size, (FED["n_clients"], 1, 4, 16)).astype(np.int32)
    runs = {}
    for tag, exp, keep, data in (
            ("j", japi.Experiment(None, strategy=jstrat,
                                  federation=JFederatedConfig(**FED))
             .with_params(jax.tree.map(jnp.asarray, params), cfg),
             _keeper(japi.eng.Callback), {"tokens": jnp.asarray(toks)}),
            ("t", Experiment(None, strategy=tstrat,
                             federation=FederatedConfig(**FED), device="cpu")
             .with_params(_tree(params), _tcfg(cfg)),
             _keeper(teng.Callback), {"tokens": _t(toks)})):
        res = (exp.with_lora(rank=LCFG.rank, alpha=LCFG.alpha)
               .with_training(rounds=1, eval_every=0, seed=0)
               .with_data(lambda r, _d=data: _d).with_callbacks(keep).run())
        runs[tag] = Run(exp.strategy, type("S", (), {"history": res.history}),
                        res.ledger, keep.flats, keep.sstates)
    assert len(runs["t"].state.history) == 1
    assert np.isfinite(runs["t"].state.history[0]["loss"])
    both = (jstrat.kept[0] != 0) & (tstrat.kept[0] != 0)
    apart = np.abs(jstrat.kept[0] - tstrat.kept[0])[both].max()
    print(f"{cfg.name}: the entries both upload apart by at most "
          f"{apart:.3e}")
    assert apart <= gap
    compare(f"flasc {cfg.name}", runs["j"], runs["t"],
            FlatMeta.of({"lora": _tree(lora)}), atol=atol)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_single_adapter_reference(arch):
    # paged adapters through every target (the grouped path's plain version
    # for the 2-D ones, the per-lane gather for mLSTM's headwise wq/wk/wv)
    # against the reference's prefill + decode_step with each request's
    # own adapter
    cfg = JR.get_config(arch, smoke=True)
    tcfg = _tcfg(cfg)
    params, _ = _weights(cfg, 70)
    rng = np.random.default_rng(71)
    adapters = {}
    for c in range(5):
        lt = _init(jax_lora.lora_spec(cfg, LCFG), 72 + c)
        adapters[c] = jax.tree.map(lambda x: x + 0.05 * rng.standard_normal(
            x.shape).astype(np.float32), lt)
    trace = TSV.synth_trace(5, 5, cfg.vocab_size, seed=3,
                            prompt_buckets=(8, 20), gen_range=(2, 6))
    store = TSV.HostAdapterStore()
    for c, lt in adapters.items():
        store.put(c, lt)
    max_len = 28
    eng = TSV.ServingEngine(
        tree_from_numpy(params, device="cpu"), tcfg,
        TSV.PagedAdapterCache(store, store.get(0), pages=2, device="cpu"),
        n_lanes=2, lora_scale=LCFG.scale, max_len=max_len, device="cpu")
    rep = eng.run(trace)
    assert len(rep.completions) == len(trace)
    assert rep.cache["evictions"] > 0 and rep.steps > 0
    jp = jax.tree.map(jnp.asarray, params)
    step = jax.jit(lambda lt, t, p, c: JM.decode_step(
        jp, cfg, t, p, c, lora=lt, lora_scale=LCFG.scale))
    pre = jax.jit(lambda lt, b: JM.prefill(jp, cfg, b, lora=lt,
                                           lora_scale=LCFG.scale,
                                           max_len=max_len))
    for req in trace:
        lt = adapters[req.client]
        lg, c = pre(lt, {"tokens": jnp.asarray([req.prompt], jnp.int32)})
        want, gaps = [], []
        pos = req.prompt_len
        while True:
            top = np.sort(np.asarray(lg[0, -1]))[-2:]
            gaps.append(float(top[1] - top[0]))
            want.append(int(jnp.argmax(lg[0, -1])))
            if len(want) == req.gen_len:
                break
            lg, c = step(lt, jnp.asarray([want[-1]], jnp.int32),
                         jnp.int32(pos), c)
            pos += 1
        got = rep.completions[req.rid]
        assert len(got) == req.gen_len
        for t, (a, b) in enumerate(zip(got, want)):
            if a != b:
                assert gaps[t] < GAP, (req, t, gaps[t])
                break


def test_write_lane_refuses_cache_trees_that_differ_in_their_leaves():
    # a lane takes every leaf of the prefill's cache, KV slots and states;
    # a leaf on one side only raises instead of leaving a state stale
    batch = {"self": (torch.zeros(2, 3, 4), torch.zeros(2, 3, 4)),
             "mamba": {"conv": torch.zeros(2, 3, 5), "h": torch.zeros(2, 3, 6)}}
    row = {"self": (torch.ones(2, 1, 4), torch.ones(2, 1, 4)),
           "mamba": {"conv": torch.ones(2, 1, 5), "h": torch.ones(2, 1, 6)}}
    TSV.ServingEngine._write_lane(batch, row, 1)
    assert all(bool((t[:, 1] == 1).all() and (t[:, 0] == 0).all())
               for t in TL.tree_leaves(batch))
    del row["self"]
    with pytest.raises(ValueError):
        TSV.ServingEngine._write_lane(batch, row, 2)


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_the_recurrent_archs_on_cpu(arch, capsys):
    from repro_torch.launch import serve
    rep = serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    assert len(rep.completions) == rep.requests == 16
    assert "16/16 requests served" in capsys.readouterr().out


def test_on_cuda_the_scan_never_falls_back(monkeypatch):
    # the wrapper's choice is by the tensors' device: a CUDA tensor goes to
    # the kernel's launch (recorded here in place of the card) and never to
    # the plain loop; under autograd the forward launches the same kernel
    # and the backward the backward's, once, and never a plain version
    called, launched, launched_bwd = [], [], []
    monkeypatch.setattr(sscan, "selective_scan_plain",
                        lambda *a, **k: called.append(1))
    monkeypatch.setattr(sscan, "selective_scan_bwd_plain",
                        lambda *a, **k: called.append(2))
    monkeypatch.setattr(sscan, "SCAN", lambda *a, **k: launched.append(a))
    monkeypatch.setattr(sscan, "SCAN_BWD",
                        lambda *a, **k: launched_bwd.append(a))

    class FakeCuda(torch.Tensor):
        is_cuda = True

    u = torch.zeros(1, 2, 16).as_subclass(FakeCuda)
    args = [torch.zeros(16, 1), torch.zeros(16), torch.zeros(16, 8),
            torch.zeros(16), torch.zeros(1, 2, 8), torch.zeros(1, 2, 8)]
    y, h = sscan.selective_scan(u, *args)
    assert len(launched) == 1 and not called
    assert launched[0][-5:] == (1, 2, 16, 8, sscan.DTYPES[torch.float32])
    assert launched[0][-6] is None          # one chunk: no scratch
    assert tuple(y.shape) == (1, 2, 16) and tuple(h.shape) == (1, 16, 8)
    u.requires_grad_(True)
    y, h = sscan.selective_scan(u, *args)
    assert len(launched) == 2 and not launched_bwd
    (du,) = torch.autograd.grad(y.sum(), u)
    assert len(launched_bwd) == 1 and not called
    # (.., dy, dh_last, du, ...): h_last unused, so no dh_last; no h0 or
    # parameter gradient asked for; B, S, di, N and u's dtype
    assert launched_bwd[0][11] is None and launched_bwd[0][15] is None
    assert launched_bwd[0][16:20] == (None,) * 4
    assert launched_bwd[0][-5:] == (1, 2, 16, 8, sscan.DTYPES[torch.float32])
    assert tuple(du.shape) == (1, 2, 16)
    with pytest.raises(ValueError, match="out_state"):
        sscan.selective_scan(u, *args, out_state=torch.zeros(1, 16, 8))
    with pytest.raises(ValueError, match="state size"):
        sscan.selective_scan(torch.zeros(1, 2, 16).as_subclass(FakeCuda),
                             args[0], args[1], torch.zeros(16, 4), args[3],
                             torch.zeros(1, 2, 4), torch.zeros(1, 2, 4))
    assert len(launched) == 2 and len(launched_bwd) == 1 and not called
