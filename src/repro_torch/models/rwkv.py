"""RWKV-6 "Finch" (arXiv:2404.05892): the attention-free LM with a
data-dependent decay per channel, in plain PyTorch.

The counterpart of ``repro/models/rwkv.py``.  The reference has no kernel
here: its WKV recurrence and token shift are ``jnp``, and so are the
port's.  Per head, with S in R^{K x V},

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)

``wkv_scan`` walks the tokens one at a time (serving, and sequences that
are not a whole number of chunks); ``wkv_chunked`` is the reference's
chunkwise form (chunks of 32, the cumulative log-decay shifted by each
chunk's mid-point so that every exponent stays within 4 * 32 / 2 = 64 in
fp32).  The reference scans the chunks one after another; the port
computes everything that does not depend on the carried state for every
chunk at once (the intra-chunk matrix and its output, each chunk's own
contribution ``k_dec^T v`` and its decay) and loops over the chunks only
for the carried state ``S_in -> S_out``, then reads every chunk's
``S_in`` in one product.  Each chunk's arithmetic is the reference's.

The parameters are an ``nn.Module``, :class:`RWKV`, whose names follow the
reference's params dict: ``embed.tok`` (and ``embed.unembed`` untied),
``final_norm.scale``, and per layer ``layers.<i>.ln1``, ``ln2``, ``tm``
(``mu`` (5, D), ``wr/wk/wv/wg/wo``, ``w0``, the decay LoRA ``wa``/``wb``,
``u`` (H, 64), ``ln_x``) and ``cm`` (``mu_k``, ``mu_r``, ``wk``, ``wv``,
``wr``); :meth:`RWKV.param_tree` is the reference's tree with each stacked
leaf as a list of per-layer tensors, the view the optimizer engine ravels.

Dtypes, as the reference has them: the token-shift mixes and every
projection in the compute dtype (weights cast at their use); the decay
LoRA's products in the compute dtype, then ``w0 + lora`` and ``-exp`` in
fp32, clipped to [-4, -1e-6]; r, k, v and the WKV in fp32; the per-head
group norm ``ln_x`` in fp32 (eps 1e-5, scale ``1 + ln_x.scale``); its
output cast back and gated by ``silu`` in the compute dtype; ``sigmoid``
and ``silu`` take ``jax.nn``'s formulas op by op (:func:`_sigmoid`).  The state
is, per layer, the last token of each mix's input (``tm_shift``,
``cm_shift``, compute dtype) and the WKV matrices (``wkv``, fp32).  An
fp64 config (``dtype="float64"``, a check of rounding: ``chip_smoke.py``
holds the two serving routes to each other in it) takes fp64 wherever
these say fp32 (``layers.wide``).

No tensor that can carry a tangent is written in place, so the training
forward runs under ``torch.func`` (Sophia-H's HVP is ``jvp`` of ``grad``).
The serving entry points run under ``torch.inference_mode()`` and update
the state in place.

Slot protocol (``serve/engine.py``): the state is slot-major, a dict of
leaves with a leading layer axis and the slot axis second.  It is bounded
(O(1) a slot whatever the request's length) and has no mask, so a reused
slot must be zeroed (:func:`reset_slot`) and a decode step writes only the
active slots' rows.  There is no int8 form and no paged KV for the prefix
cache.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig, check_supported
from .layers import (dense_init, embed, init_embedding, rms_norm, unembed,
                     wide)
from .transformer import REMATS, _checkpointed, _params, _stack, _Tree

HEAD_DIM = 64
DECAY_LORA = 64
CHUNK = 32
LOG_DECAY_CLAMP = 4.0  # per-step log-decay clamped to [-4, -1e-6]

# the leaves of one layer (init_layer's tree), as paths
LAYER_LEAVES = ("cm/mu_k", "cm/mu_r", "cm/wk", "cm/wr", "cm/wv", "ln1/scale",
                "ln2/scale", "tm/ln_x/scale", "tm/mu", "tm/u", "tm/w0",
                "tm/wa", "tm/wb", "tm/wg", "tm/wk", "tm/wo", "tm/wr",
                "tm/wv")


def n_heads(cfg: ModelConfig) -> int:
    return cfg.d_model // HEAD_DIM


# ---------------------------------------------------------------------------
# params


def _leaf_paths(tree, prefix="") -> Tuple[str, ...]:
    out = []
    for name in sorted(tree.keys()):
        value = tree[name]
        path = prefix + name
        if isinstance(value, (dict, _Tree)):
            out.extend(_leaf_paths(value, path + "/"))
        else:
            out.append(path)
    return tuple(out)


class RWKV(nn.Module):
    """Parameters of the RWKV-6 LM, from a tree shaped like the reference's
    params dict with the layer stack as a list of per-layer dicts.  A leaf
    the port does not know raises."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__()
        check_supported(cfg)
        if cfg.family != "rwkv":
            raise ValueError(f"config {cfg.name!r} is of family "
                             f"{cfg.family!r}, not rwkv")
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a config "
                             f"of {cfg.n_layers}")
        for i, layer in enumerate(tree["layers"]):
            if _leaf_paths(layer) != LAYER_LEAVES:
                raise ValueError(f"layer {i} has leaves "
                                 f"{_leaf_paths(layer)}, not {LAYER_LEAVES}")
        embed_keys = ("tok",) if cfg.tie_embeddings else ("tok", "unembed")
        if tuple(sorted(tree["embed"])) != embed_keys:
            raise ValueError(f"embed has {sorted(tree['embed'])}, not "
                             f"{list(embed_keys)}")
        if tuple(tree["final_norm"]) != ("scale",):
            raise ValueError(f"final_norm has {sorted(tree['final_norm'])}")
        self.cfg = cfg
        self.embed = _params(tree["embed"])
        self.final_norm = _params(tree["final_norm"])
        self.layers = nn.ModuleList(_Tree(t) for t in tree["layers"])

    def param_tree(self) -> dict:
        """The reference's params dict over this module's parameters; each
        leaf under ``"layers"`` is a list of the per-layer tensors."""
        return {"embed": dict(self.embed.items()),
                "final_norm": dict(self.final_norm.items()),
                "layers": _stack(list(self.layers))}


def init_layer(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    dev = gen.device

    def full(shape, value):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    return {
        "ln1": {"scale": full((D,), 0.0)},
        "ln2": {"scale": full((D,), 0.0)},
        "tm": {
            "mu": full((5, D), 0.5),             # r, k, v, g, w shift mix
            "wr": dense_init(gen, (D, D)),
            "wk": dense_init(gen, (D, D)),
            "wv": dense_init(gen, (D, D)),
            "wg": dense_init(gen, (D, D)),
            "wo": dense_init(gen, (D, D), in_axis=0),
            "w0": full((D,), -5.0),              # base decay (slow)
            "wa": dense_init(gen, (D, DECAY_LORA)) * 0.1,
            "wb": dense_init(gen, (DECAY_LORA, D), in_axis=0) * 0.1,
            "u": torch.randn((n_heads(cfg), HEAD_DIM), generator=gen,
                             device=dev) * 0.1,
            "ln_x": {"scale": full((D,), 0.0)},
        },
        "cm": {
            "mu_k": full((D,), 0.5),
            "mu_r": full((D,), 0.5),
            "wk": dense_init(gen, (D, F_)),
            "wv": dense_init(gen, (F_, D), in_axis=0),
            "wr": dense_init(gen, (D, D)),
        },
    }


# the reference's init_embedding_rwkv: ``tok`` and, untied, ``unembed``
# (an RWKV config has no learned positions)
init_embedding_rwkv = init_embedding


def init_params(cfg: ModelConfig, gen: torch.Generator) -> RWKV:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    tree = {"embed": init_embedding_rwkv(gen, cfg),
            "layers": [init_layer(cfg, gen) for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.zeros((cfg.d_model,),
                                                device=gen.device)}}
    return RWKV(cfg, tree)


# ---------------------------------------------------------------------------
# token shift and decay


def _sigmoid(x):
    """``jax.nn.sigmoid``'s formula, ``1 / (1 + exp(-x))``, each op rounded
    to x's dtype: in bf16 ``torch.sigmoid`` rounds once and differs from
    it by an ulp in a third of the elements."""
    return 1.0 / (1.0 + torch.exp(-x))


def _silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)`` (:func:`_sigmoid`)."""
    return x * _sigmoid(x)


def _token_shift(x, prev):
    """x (B, S, D), prev (B, D) the previous token -> x shifted by one."""
    return torch.cat([prev[:, None], x[:, :-1]], dim=1)


def _decay(tm, xw):
    """Data-dependent per-channel log-decay, clamped for fp32 chunk math."""
    dt = xw.dtype
    lora = torch.tanh(xw @ tm["wa"].to(dt)) @ tm["wb"].to(dt)
    f32 = wide(dt)
    raw = tm["w0"].to(f32) + lora.to(f32)
    logw = -torch.exp(raw)                     # always negative
    return torch.clamp(logw, -LOG_DECAY_CLAMP, -1e-6)


# ---------------------------------------------------------------------------
# WKV


def wkv_scan(r, k, v, logw, u, state):
    """Exact sequential WKV.  r, k, v, logw (B, S, H, K); u (H, K); state
    (B, H, K, V).  Returns (out (B, S, H, V), final state)."""
    outs = []
    for t in range(r.shape[1]):
        r_t, k_t, v_t, lw_t = r[:, t], k[:, t], v[:, t], logw[:, t]
        kv = k_t[..., :, None] * v_t[..., None, :]      # (B, H, K, V)
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t,
                                 state + u[None, :, :, None] * kv))
        state = torch.exp(lw_t)[..., None] * state + kv
    return torch.stack(outs, dim=1), state


def wkv_chunked(r, k, v, logw, u, state, chunk: int = CHUNK):
    """Chunkwise WKV, the signature and values of :func:`wkv_scan`.  S must
    be a multiple of ``chunk``.  Chunks sit on an axis of their own (B, H,
    n, C, K); only the carried state loops over them."""
    B, S, H, K = r.shape
    V = v.shape[-1]
    if S % chunk:
        raise ValueError(f"seq {S} % chunk {chunk} != 0")
    n = S // chunk
    f32 = wide(r.dtype)

    def split(t):
        return t.to(f32).reshape(B, n, chunk, H, t.shape[-1]).permute(
            0, 3, 1, 2, 4)

    rt, kt, vt, lw = map(split, (r, k, v, logw))        # (B, H, n, C, K)
    LP = torch.cumsum(lw, dim=3)                        # inclusive log-prods
    LP_prev = LP - lw                                   # exclusive
    mid = LP[:, :, :, chunk // 2:chunk // 2 + 1]        # per-channel shift
    # intra-chunk: A[t,i] = sum_c r[t,c] k[i,c] exp(LP_prev[t,c]-LP[i,c])
    r_sh = rt * torch.exp(LP_prev - mid)
    k_sh = kt * torch.exp(mid - LP)
    A = r_sh @ k_sh.transpose(-1, -2)                   # (B, H, n, C, C)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=A.device), diagonal=-1)
    A = torch.where(tri, A, 0.0)
    # current-token bonus via the diagonal
    bonus = ((rt * u[None, :, None, None, :]) * kt).sum(-1)
    A = A + torch.eye(chunk, device=A.device) * bonus[..., None]
    o_intra = A @ vt
    # each chunk's own state contribution and decay:
    # S_out = diag(exp(LP_end)) S_in + sum_i (exp(LP_end - LP_i) k_i) v_i
    LP_end = LP[:, :, :, -1:]
    kv = (kt * torch.exp(LP_end - LP)).transpose(-1, -2) @ vt  # (B,H,n,K,V)
    dec = torch.exp(LP_end.squeeze(3))[..., None]              # (B,H,n,K,1)
    # unbind, not an index a chunk: the backward of an index would build a
    # zero gradient of the whole (B, H, n, K, V) tensor for every chunk
    s = state.to(f32)
    s_in = []
    for dec_c, kv_c in zip(dec.unbind(2), kv.unbind(2)):
        s_in.append(s)
        s = dec_c * s + kv_c
    # inter-chunk: r~_t = r_t exp(LP_prev) reads each chunk's S_in
    o_state = (rt * torch.exp(LP_prev)) @ torch.stack(s_in, dim=2)
    out = (o_intra + o_state).permute(0, 2, 3, 1, 4).reshape(B, S, H, V)
    return out, s


# ---------------------------------------------------------------------------
# blocks


def time_mix(tm, x, cfg: ModelConfig, prev_tok, wkv_state, *,
             chunked: bool = True):
    """x (B, S, D) normed input.  Returns (out, last token, new WKV
    state)."""
    dt = x.dtype
    B, S, D = x.shape
    H = n_heads(cfg)
    xs = _token_shift(x, prev_tok)
    mu = tm["mu"].to(dt)
    xr, xk, xv, xg, xw = (x + (xs - x) * mu[i] for i in range(5))
    r = (xr @ tm["wr"].to(dt)).reshape(B, S, H, HEAD_DIM)
    k = (xk @ tm["wk"].to(dt)).reshape(B, S, H, HEAD_DIM)
    v = (xv @ tm["wv"].to(dt)).reshape(B, S, H, HEAD_DIM)
    g = _silu(xg @ tm["wg"].to(dt))
    logw = _decay(tm, xw).reshape(B, S, H, HEAD_DIM)
    f32 = wide(dt)
    u = tm["u"].to(f32)
    fn = wkv_chunked if (chunked and S % CHUNK == 0) else wkv_scan
    o, new_state = fn(r.to(f32), k.to(f32), v.to(f32), logw, u, wkv_state)
    # per-head group norm (RWKV "ln_x")
    o = o.reshape(B, S, H, HEAD_DIM)
    o = o * torch.rsqrt(o.square().mean(-1, keepdim=True) + 1e-5)
    o = o.reshape(B, S, D) * (1.0 + tm["ln_x"]["scale"].to(f32))
    out = (o.to(dt) * g) @ tm["wo"].to(dt)
    return out, x[:, -1], new_state


def channel_mix(cm, x, prev_tok):
    """x (B, S, D) normed input.  Returns (out, last token)."""
    dt = x.dtype
    xs = _token_shift(x, prev_tok)
    xk = x + (xs - x) * cm["mu_k"].to(dt)
    xr = x + (xs - x) * cm["mu_r"].to(dt)
    kk = torch.square(F.relu(xk @ cm["wk"].to(dt)))
    return (_sigmoid(xr @ cm["wr"].to(dt)) * (kk @ cm["wv"].to(dt)),
            x[:, -1])


# ---------------------------------------------------------------------------
# state


def _zero_layer_state(cfg: ModelConfig, B: int, device="cpu") -> dict:
    H = n_heads(cfg)
    return {"tm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.compute_dtype,
                                    device=device),
            "cm_shift": torch.zeros((B, cfg.d_model), dtype=cfg.compute_dtype,
                                    device=device),
            "wkv": torch.zeros((B, H, HEAD_DIM, HEAD_DIM),
                               dtype=wide(cfg.compute_dtype),
                               device=device)}


def init_state(cfg: ModelConfig, batch_size: int, device="cpu") -> dict:
    """Zeroed per-layer recurrent state (the RWKV 'KV cache'): each leaf
    with a leading layer axis, the batch (slot) axis second."""
    return {name: z.new_zeros((cfg.n_layers,) + tuple(z.shape))
            for name, z in _zero_layer_state(cfg, batch_size,
                                             device).items()}


# ---------------------------------------------------------------------------
# training forward


def forward_hidden(cfg: ModelConfig, params: RWKV, tokens, *, state=None,
                   remat: str = "none", chunked: bool = True,
                   last_only: bool = False, final_norm: bool = True):
    """tokens (B, S) -> (hidden (B, S, D), aux, new state): the trunk
    shared by :func:`forward` and the losses, from ``state`` (zeros by
    default).  ``final_norm=False`` returns the PRE-norm hidden, which the
    fused loss normalizes inside its sweep; ``last_only`` keeps the last
    token.  ``aux`` is 0 (fp32).  ``remat="full"`` recomputes each layer
    in the backward (``torch.utils.checkpoint``); "dots" and "scan2" run
    as "none", as in the reference."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (one of {REMATS})")
    B, S = tokens.shape
    x = embed(params.embed, tokens, cfg)
    if state is None:
        state = init_state(cfg, B, x.device)

    def layer_fn(i):
        p = params.layers[i]

        def run(x, tm_shift, cm_shift, wkv):
            h = rms_norm(x, p["ln1"]["scale"], cfg.norm_eps)
            o, last_tm, wkv = time_mix(p["tm"], h, cfg, tm_shift, wkv,
                                       chunked=chunked)
            x = x + o
            h = rms_norm(x, p["ln2"]["scale"], cfg.norm_eps)
            o, last_cm = channel_mix(p["cm"], h, cm_shift)
            return x + o, last_tm, last_cm, wkv
        return run

    new = {name: [] for name in ("tm_shift", "cm_shift", "wkv")}
    for i in range(len(params.layers)):
        run = layer_fn(i)
        if remat == "full":
            run = _checkpointed(run, "full")
        x, last_tm, last_cm, wkv = run(x, state["tm_shift"][i],
                                       state["cm_shift"][i], state["wkv"][i])
        new["tm_shift"].append(last_tm)
        new["cm_shift"].append(last_cm)
        new["wkv"].append(wkv)
    if last_only:
        x = x[:, -1:]
    if final_norm:
        x = rms_norm(x, params.final_norm["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, {name: torch.stack(v) for name, v in new.items()}


def forward(cfg: ModelConfig, params: RWKV, tokens, *, state=None,
            remat: str = "none", chunked: bool = True,
            last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux, new state)."""
    x, aux, new_state = forward_hidden(cfg, params, tokens, state=state,
                                       remat=remat, chunked=chunked,
                                       last_only=last_only)
    return unembed(params.embed, x, cfg), aux, new_state


def loss_fn(cfg: ModelConfig, params: RWKV, batch, *, remat="none",
            loss_impl=None, attn_impl=None):
    """batch {tokens, labels, [mask]} -> (ce, {"ce", "aux"}), the CE with
    the final RMSNorm fused into the loss route (``pre_norm="rms"``);
    ``aux`` is 0.  ``attn_impl``, which the trainer passes every family,
    is ignored: there is no attention."""
    from .loss import lm_loss
    hidden, aux, _ = forward_hidden(cfg, params, batch["tokens"],
                                    remat=remat, final_norm=False)
    ce, _ = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"),
                    impl=loss_impl, pre_norm="rms")
    return ce, {"ce": ce, "aux": aux}


def sampled_loss_fn(cfg: ModelConfig, params: RWKV, batch, seed, *,
                    remat="none", loss_impl=None, attn_impl=None, **draws):
    """GNB's sampled-label NLL: ``(nll, n_valid)``, the labels drawn from
    the model's own softmax (``models/loss.py:lm_loss_sampled``)."""
    from .loss import lm_loss_sampled
    hidden, _, _ = forward_hidden(cfg, params, batch["tokens"], remat=remat,
                                  final_norm=False)
    return lm_loss_sampled(cfg, params, hidden, seed, batch.get("mask"),
                           impl=loss_impl, pre_norm="rms", **draws)


def logits_fn(cfg: ModelConfig, params: RWKV, batch, **_):
    """The logits (B, S, V) fp32 of ``batch["tokens"]`` (the reference's
    ``logits_fn``, which takes no remat)."""
    return forward(cfg, params, batch["tokens"])[0]


# ---------------------------------------------------------------------------
# serving: one token at a time through the O(1) recurrence


def _write_state(state, new, active=None):
    """Copy ``new`` into ``state`` in place, only the slots (axis 1) where
    ``active`` is True when given."""
    for name, leaf in state.items():
        upd = new[name]
        if active is not None:
            m = active.reshape((1, -1) + (1,) * (leaf.dim() - 2))
            upd = torch.where(m, upd, leaf)
        leaf.copy_(upd)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: RWKV, state, tokens,
                position=None):
    """One decode step: tokens (B, 1) -> logits (B, 1, V) fp32, the state
    updated in place.  ``position`` is taken for the attention families'
    signature and ignored: the recurrence is position-free."""
    logits, _, new = forward(cfg, params, tokens, state=state, chunked=False)
    _write_state(state, new)
    return logits


def init_slots(cfg: ModelConfig, n_slots: int, cache_len: int = 0,
               device="cpu") -> dict:
    """The zeroed state of ``n_slots`` slots (:func:`init_state`);
    ``cache_len`` is ignored: the state is O(1) whatever a request's
    length."""
    if cfg.kv_dtype != "bf16":
        raise ValueError("kv_dtype=int8 is implemented for the paged-KV "
                         "families (dense/moe); rwkv has no KV cache")
    return init_state(cfg, n_slots, device)


@torch.inference_mode()
def reset_slot(cfg: ModelConfig, state, slot):
    """Zero slot ``slot``'s rows of every leaf in place.  Unlike the ring
    KV cache, a reused slot needs it: no mask hides the last request's
    recurrence."""
    for leaf in state.values():
        leaf[:, slot].zero_()
    return state


@torch.inference_mode()
def decode_slots(cfg: ModelConfig, params: RWKV, state, tokens, positions,
                 active=None):
    """One decode step across all slots: tokens (N, 1) -> logits (N, 1, V)
    fp32.  The positions are ignored.  The new state is written only where
    ``active`` (N,) bool is True, when given, so that a slot between
    prefill chunks or free comes out of a decode burst unchanged (the
    reference's ``_select_slots``)."""
    logits, _, new = forward(cfg, params, tokens, state=state, chunked=False)
    _write_state(state, new, active)
    return logits


@torch.inference_mode()
def prefill_into_slot(cfg: ModelConfig, params: RWKV, state, slot: int,
                      tokens, start: int, n_valid: int):
    """Chunk-prefill one slot: tokens (1, P), of which the first
    ``n_valid`` are real.  Absorbs exactly those tokens (the projections
    batched over them, the WKV the sequential recurrence), updating the
    slot's rows in place, and returns the logits (V,) fp32 of the last of
    them; the padded tail never touches the state.  ``start`` is ignored:
    the recurrence is position-free."""
    row = {name: leaf[:, slot:slot + 1] for name, leaf in state.items()}
    x, _, new = forward_hidden(cfg, params, tokens[:, :n_valid], state=row,
                               chunked=False, last_only=True)
    _write_state(row, new)
    return unembed(params.embed, x, cfg)[0, -1]
