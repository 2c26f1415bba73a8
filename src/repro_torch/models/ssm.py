"""Sub-quadratic sequence mixers in plain PyTorch: RWKV-6 ("Finch") and
Mamba-2 (SSD), sharing one chunked linear-attention core.

The port of ``repro.models.ssm``.  The recurrence  S_t+1 = diag(w_t) S_t +
k_t (x) v_t,  y_t = q_t S_t (+bonus)  is evaluated chunk-parallel: within
a chunk of C tokens the pairwise decay ratio exp(L_t - Lin_s) is formed
from clamped per-step log-decays (lw >= LOG_DECAY_MIN, so |cumsum| <=
C*|min| stays inside float32 exp range), and across chunks a loop carries
the (K, V) state with every decay factor <= 1.  ``CHUNK`` and the clamp
change results, not only rounding, so both are ``repro``'s.  Every
function keeps ``repro``'s dtypes: a bf16 activation times a float32
weight computes in float32, as JAX promotes it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .common import ModelConfig, Params, dense_init, matmul, rms_norm

LOG_DECAY_MIN = -2.5     # per-step clamp; with CHUNK=32 -> |cum| <= 80 < 88
CHUNK = 32


# ---------------------------------------------------------------------------
# Chunked linear attention core
# ---------------------------------------------------------------------------


def _pad_seq(x: torch.Tensor, pad: int) -> torch.Tensor:
    return F.pad(x, (0, 0, 0, 0, 0, pad))


def chunked_linear_attention(q, k, v, log_decay, *, bonus=None,
                             inclusive: bool = False, chunk: int = CHUNK,
                             state: Optional[torch.Tensor] = None):
    """q,k: (B,S,H,K); v: (B,S,H,V); log_decay: broadcastable to (B,S,H,K).

    ``inclusive``: decay applies to the current token too (Mamba-2), with
    an implicit identity bonus; otherwise (RWKV-6) the current token
    contributes through ``bonus`` (H,K) only.  Returns (y: (B,S,H,V) in
    v's dtype, final state (B,H,K,V) float32)."""
    B, S, H, K = q.shape
    V = v.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    lw = log_decay.float().broadcast_to((B, S, H, K))
    if pad:
        q, k, v, lw = (_pad_seq(x, pad) for x in (q, k, v, lw))
    Sp = S + pad
    nc = Sp // chunk

    lw = torch.clamp(lw, min=LOG_DECAY_MIN).reshape(B, nc, chunk, H, K)
    qc = q.reshape(B, nc, chunk, H, K).float()
    kc = k.reshape(B, nc, chunk, H, K).float()
    vc = v.reshape(B, nc, chunk, H, V).float()

    lin = torch.cumsum(lw, dim=2)         # inclusive prefix  Lin_t
    lex = lin - lw                        # exclusive prefix  L_t
    ltot = lin[:, :, -1]                  # chunk totals      (B,nc,H,K)

    q_exp = lin if inclusive else lex
    qt = qc * torch.exp(q_exp)            # bounded above by |q|
    kt = kc * torch.exp(-lin)             # bounded by exp(C*|min|)
    kstate = kc * torch.exp(ltot[:, :, None] - lin)   # factors <= 1

    # intra-chunk attention
    a = torch.einsum("bnchk,bnshk->bnhcs", qt, kt)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=q.device), diagonal=-1)
    a = torch.where(tri, a, 0.0)
    eye = torch.eye(chunk, device=q.device)
    if inclusive:
        diag = torch.einsum("bnchk,bnchk->bnhc", qc, kc)
        a = a + diag[..., None] * eye
    elif bonus is not None:
        diag = torch.einsum("bnchk,hk,bnchk->bnhc", qc, bonus.float(), kc)
        a = a + diag[..., None] * eye
    y_intra = torch.einsum("bnhcs,bnshv->bnchv", a, vc)

    # inter-chunk: carry the state across chunks
    s = (torch.zeros((B, H, K, V), dtype=torch.float32, device=q.device)
         if state is None else state)
    y_inter = []
    for i in range(nc):
        y_inter.append(torch.einsum("bchk,bhkv->bchv", qt[:, i], s))
        upd = torch.einsum("bchk,bchv->bhkv", kstate[:, i], vc[:, i])
        s = s * torch.exp(ltot[:, i])[..., None] + upd
    y = y_intra + torch.stack(y_inter, dim=1)
    y = y.reshape(B, Sp, H, V)[:, :S]
    return y.to(v.dtype), s


def linear_attention_step(q, k, v, log_decay, state, *, bonus=None,
                          inclusive: bool = False):
    """Single-token recurrence for decode.  q,k: (B,H,K); v: (B,H,V);
    state: (B,H,K,V) -> (y: (B,H,V), new state)."""
    lw = torch.clamp(log_decay.float().broadcast_to(q.shape),
                     min=LOG_DECAY_MIN)
    q32, k32, v32 = (x.float() for x in (q, k, v))
    kv = torch.einsum("bhk,bhv->bhkv", k32, v32)
    if inclusive:
        state = state * torch.exp(lw)[..., None] + kv
        y = torch.einsum("bhk,bhkv->bhv", q32, state)
    else:
        eff = state + (bonus.float()[None, :, :, None] * kv
                       if bonus is not None else kv * 0)
        y = torch.einsum("bhk,bhkv->bhv", q32, eff)
        state = state * torch.exp(lw)[..., None] + kv
    return y.to(v.dtype), state


# ---------------------------------------------------------------------------
# RWKV-6 ("Finch") block
# ---------------------------------------------------------------------------

RWKV_HEAD = 64       # official head size
MAA_RANK = 32        # token-shift ddlerp LoRA rank
DECAY_RANK = 64      # data-dependent decay LoRA rank


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    d, ff = cfg.d_model, cfg.d_ff
    H = d // RWKV_HEAD
    dt = cfg.param_dtype

    def z(*s):
        return torch.zeros((n,) + s, dtype=dt, device=gen.device)

    return {
        "ln1": z(d), "ln2": z(d),
        # time-mix (ddlerp): base mixes + low-rank data-dependent part
        "maa_x": z(d), "maa_wkvrg": z(5, d),
        "maa_w1": dense_init(gen, (n, d, 5 * MAA_RANK), dt),
        "maa_w2": dense_init(gen, (n, 5, MAA_RANK, d), dt, fan_in=MAA_RANK),
        # data-dependent decay; w ~ exp(-exp(-4)) ~ .98
        "decay_base": torch.full((n, d), -4.0, dtype=dt, device=gen.device),
        "decay_w1": dense_init(gen, (n, d, DECAY_RANK), dt),
        "decay_w2": dense_init(gen, (n, DECAY_RANK, d), dt,
                               fan_in=DECAY_RANK),
        "bonus": dense_init(gen, (n, H, RWKV_HEAD), dt, fan_in=RWKV_HEAD),
        "wr": dense_init(gen, (n, d, d), dt),
        "wk": dense_init(gen, (n, d, d), dt),
        "wv": dense_init(gen, (n, d, d), dt),
        "wg": dense_init(gen, (n, d, d), dt),
        "wo": dense_init(gen, (n, d, d), dt),
        "ln_x": z(d),
        # channel-mix
        "cm_mk": z(d), "cm_mr": z(d),
        "cm_k": dense_init(gen, (n, d, ff), dt),
        "cm_v": dense_init(gen, (n, ff, d), dt, fan_in=ff),
        "cm_r": dense_init(gen, (n, d, d), dt),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x: (B,S,d); prev: (B,d) = last token of the previous segment."""
    dt = torch.promote_types(x.dtype, prev.dtype)
    return torch.cat([prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def rwkv6_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   shift_prev: torch.Tensor, state: Optional[torch.Tensor],
                   chunk: int = CHUNK):
    B, S, d = x.shape
    H = d // RWKV_HEAD
    xs = _token_shift(x, shift_prev)
    xx = xs - x
    # ddlerp: data-dependent token-shift mixing for w,k,v,r,g
    base = x + xx * p["maa_x"]
    mixl = torch.tanh(matmul(base, p["maa_w1"])).reshape(B, S, 5, MAA_RANK)
    dt = torch.promote_types(mixl.dtype, p["maa_w2"].dtype)
    mix = torch.einsum("bsfr,frd->bsfd", mixl.to(dt),
                       p["maa_w2"].to(dt))                 # (B,S,5,d)
    mix = mix + p["maa_wkvrg"]
    xw, xk, xv, xr, xg = (x + xx * mix[:, :, i] for i in range(5))

    lw = -torch.exp(p["decay_base"] + matmul(
        torch.tanh(matmul(xw, p["decay_w1"])), p["decay_w2"]))
    r = matmul(xr, p["wr"]).reshape(B, S, H, RWKV_HEAD)
    k = matmul(xk, p["wk"]).reshape(B, S, H, RWKV_HEAD)
    v = matmul(xv, p["wv"]).reshape(B, S, H, RWKV_HEAD)
    g = F.silu(matmul(xg, p["wg"]))
    lw = lw.reshape(B, S, H, RWKV_HEAD)

    y, state = chunked_linear_attention(r, k, v, lw, bonus=p["bonus"],
                                        inclusive=False, chunk=chunk,
                                        state=state)
    y = y.reshape(B, S, d)
    y = rms_norm(y, p["ln_x"], cfg.norm_eps) * g
    return matmul(y, p["wo"]).to(x.dtype), x[:, -1], state


def rwkv6_channel_mix(p: Params, x: torch.Tensor, *,
                      shift_prev: torch.Tensor):
    xs = _token_shift(x, shift_prev)
    xx = xs - x
    xk = x + xx * p["cm_mk"]
    xr = x + xx * p["cm_mr"]
    kk = torch.square(torch.relu(matmul(xk, p["cm_k"])))
    out = torch.sigmoid(matmul(xr, p["cm_r"])) * matmul(kk, p["cm_v"])
    return out.to(x.dtype), x[:, -1]


def rwkv6_block(p: Params, x: torch.Tensor, cfg: ModelConfig, cache=None,
                chunk: int = CHUNK):
    """cache: {"shift1": (B,d), "shift2": (B,d), "state": (B,H,K,V)}.
    -> (x', new cache): new tensors, as ``repro`` returns them (the
    shifts in the block's dtype, the state float32)."""
    B, S, d = x.shape
    H = d // RWKV_HEAD
    if cache is None:
        cache = {
            "shift1": torch.zeros((B, d), dtype=x.dtype, device=x.device),
            "shift2": torch.zeros((B, d), dtype=x.dtype, device=x.device),
            "state": torch.zeros((B, H, RWKV_HEAD, RWKV_HEAD),
                                 dtype=torch.float32, device=x.device),
        }
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    a, s1, st = rwkv6_time_mix(p, h, cfg, shift_prev=cache["shift1"],
                               state=cache["state"], chunk=chunk)
    x = x + a
    h2 = rms_norm(x, p["ln2"], cfg.norm_eps)
    m, s2 = rwkv6_channel_mix(p, h2, shift_prev=cache["shift2"])
    x = x + m
    return x, {"shift1": s1.to(x.dtype), "shift2": s2.to(x.dtype),
               "state": st}


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) block
# ---------------------------------------------------------------------------

MAMBA_HEAD = 64
MAMBA_CONV = 4


def init_mamba2(gen: torch.Generator, cfg: ModelConfig, n: int) -> Params:
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    nh = di // MAMBA_HEAD
    dt = cfg.param_dtype
    dev = gen.device
    return {
        "ln": torch.zeros((n, d), dtype=dt, device=dev),
        # fused input projection: [z (di), x (di), B (ds), C (ds), dt (nh)]
        "in_proj": dense_init(gen, (n, d, 2 * di + 2 * ds + nh), dt),
        "conv_w": dense_init(gen, (n, MAMBA_CONV, di + 2 * ds), dt,
                             fan_in=MAMBA_CONV),
        "a_log": torch.zeros((n, nh), dtype=dt, device=dev),  # A=-exp(a_log)
        "dt_bias": torch.full((n, nh), -2.0, dtype=dt, device=dev),
        "d_skip": torch.ones((n, nh), dtype=dt, device=dev),
        "out_ln": torch.zeros((n, di), dtype=dt, device=dev),
        "out_proj": dense_init(gen, (n, di, d), dt, fan_in=di),
    }


def mamba2_block(p: Params, x: torch.Tensor, cfg: ModelConfig, cache=None,
                 chunk: int = CHUNK):
    """cache: {"conv": (B, MAMBA_CONV-1, di+2ds), "state": (B,nh,ds,hd)}.
    -> (x', new cache): new tensors, as ``repro`` returns them (the conv
    window in the input projection's dtype, the state float32)."""
    B, S, d = x.shape
    di = cfg.ssm_expand * d
    ds = cfg.ssm_state
    nh = di // MAMBA_HEAD
    decode = cache is not None and S == 1
    if cache is None:
        cache = {
            "conv": torch.zeros((B, MAMBA_CONV - 1, di + 2 * ds),
                                dtype=x.dtype, device=x.device),
            "state": torch.zeros((B, nh, ds, MAMBA_HEAD),
                                 dtype=torch.float32, device=x.device),
        }
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    zxbcdt = matmul(h, p["in_proj"])
    z, xc, dt_raw = torch.split(zxbcdt, [di, di + 2 * ds, nh], dim=-1)
    # causal depthwise conv over (x, B, C)
    cdt = torch.promote_types(cache["conv"].dtype, xc.dtype)
    seq = torch.cat([cache["conv"].to(cdt), xc.to(cdt)], dim=1)
    conv_cache = seq[:, -(MAMBA_CONV - 1):]
    stacked = torch.stack([seq[:, i:i + S] for i in range(MAMBA_CONV)],
                          dim=2)                           # (B,S,4,C)
    wdt = torch.promote_types(cdt, p["conv_w"].dtype)
    xc = F.silu(torch.einsum("bskc,kc->bsc", stacked.to(wdt),
                             p["conv_w"].to(wdt)))
    xs, bmat, cmat = torch.split(xc, [di, ds, ds], dim=-1)

    dtv = torch.logaddexp(dt_raw + p["dt_bias"],
                          torch.zeros((), dtype=dt_raw.dtype,
                                      device=x.device))    # softplus
    a = -torch.exp(p["a_log"].float())                     # (nh,)
    lw = (dtv.float() * a)[..., None]                      # (B,S,nh,1)

    xh = xs.reshape(B, S, nh, MAMBA_HEAD)
    # B/C shared across heads (n_groups=1): broadcast to (B,S,nh,ds)
    bh = bmat[:, :, None].broadcast_to((B, S, nh, ds))
    ch = cmat[:, :, None].broadcast_to((B, S, nh, ds))
    kv = xh * dtv[..., None]                               # dt-scaled input

    if decode:
        y, state = linear_attention_step(
            ch[:, 0], bh[:, 0], kv[:, 0], lw[:, 0], cache["state"],
            inclusive=True)
        y = y[:, None]
    else:
        y, state = chunked_linear_attention(ch, bh, kv, lw, inclusive=True,
                                            chunk=chunk,
                                            state=cache["state"])
    y = y + xh * p["d_skip"][:, None]
    y = y.reshape(B, S, di)
    y = rms_norm(y, p["out_ln"], cfg.norm_eps) * F.silu(z)
    out = matmul(y, p["out_proj"]).to(x.dtype)
    return x + out, {"conv": conv_cache, "state": state}
