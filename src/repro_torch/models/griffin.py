"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU recurrent blocks
interleaved with local (sliding-window) MQA attention at 2:1, in plain
PyTorch around the port's attention and CE kernels.

The counterpart of ``repro/models/griffin.py``.  Layers come in groups of
(recurrent, recurrent, local attention); ``n_layers % 3`` recurrent layers
follow as the tail (recurrentgemma-2b: 8 groups + 2).  The RG-LRU is the
diagonal linear recurrence

    a_t = exp(c * r_t * log sigmoid(Lambda))          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

The reference evaluates it with ``lax.associative_scan`` (``jnp``, no
Pallas kernel); the port with a log-depth doubling scan in plain PyTorch
(:func:`linear_scan`: Hillis-Steele, ceil(log2 S) passes, 12 at S 4096)
whose backward is the same scan run backwards, so that autograd keeps a and
h of each layer and not every pass's intermediates.  The causal conv and
the decode path's rolling attention are ``jnp`` in the reference and plain
PyTorch here.  Training attention is ``layers.train_attention`` with the
config's window (the flash kernels at hd 256, group 10, window 2048 for
recurrentgemma-2b).  The reference's ``loss_fn`` drops the trainer's
``attn_impl`` (``**_``) and trains on its "auto" route; the port passes it
through, as the dense family does.

Parameters are an ``nn.Module``, :class:`Griffin`, whose names follow the
reference's tree: ``embed.tok`` (``embed.unembed`` untied),
``final_norm.scale``, ``groups.<i>.rec1``/``rec2`` (``ln``, ``w_in``,
``w_gate``, ``conv_k`` (cw, W), ``conv_b``, ``lam``, ``w_a``, ``b_a``,
``w_x``, ``b_x``, ``w_out``, ``ln_mlp``, ``mlp``), ``groups.<i>.attn``
(``ln``, ``attn.wq/wk/wv/wo``, ``ln_mlp``, ``mlp``) and ``tail.<j>``, a
recurrent block.  :meth:`Griffin.param_tree` is the reference's tree with
``groups`` stacked over the groups and ``tail`` over the tail layers, each
stacked leaf a list of tensors: the view the optimizer engine ravels and
the checkpoint writes.

Dtypes, as the reference has them: norms in fp32 (RMSNorm, every block,
whatever ``norm_type`` says); the projections, the conv (summed tap by tap
in the compute dtype) and the GeGLU in the compute dtype; ``w_a``, ``w_x``,
the gates and the RG-LRU in fp32 (:func:`layers.wide`, fp64 in an fp64
config).  No tensor that can carry a tangent is written in place, so the
training forward runs under ``torch.func`` (Sophia-H's HVP).

Serving.  The state is the reference's, slot-major: ``rec1``, ``rec2`` and
``tail`` hold ``conv`` (n, N, cw - 1, W) in the compute dtype and ``h``
(n, N, W) in fp32, and ``kv`` holds ``k``/``v`` (g, N, local_window, Hkv,
hd), a ring of the window's size.  ``decode_slots`` attends that ring
through ``layers.decode_attention_slots`` (the decode kernel on the card;
the ring mask is the window), writing the state only for the active slots;
``prefill_into_slot`` feeds a chunk one token at a time through
``decode_slots`` on the slot's row, as the reference does (a chunk batched
over its tokens would overwrite, once it wraps the ring, keys its own
earlier queries still read).  ``reset_slot`` zeroes the recurrent state
and leaves the ring, which the mask hides.  ``decode_step`` (the lockstep
path) runs every row at one position with the reference's
``_rolling_attention``.  There is no int8 cache and no paged KV for the
prefix cache.  The serving entry points run under
``torch.inference_mode()`` and update the state in place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.decode_attention import NEG_INF
from .common import ModelConfig, check_supported
from .layers import (_qkv, attention_scores_block, decode_attention_slots,
                     dense_init, embed, init_attention, init_embedding,
                     init_mlp, mlp, rms_norm, train_attention, unembed,
                     wide)
from .transformer import REMATS, _checkpointed, _params, _stack, _Tree

RG_LRU_C = 8.0


def rnn_width(cfg: ModelConfig) -> int:
    return cfg.rnn_width or cfg.d_model


def n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // 3


def n_tail(cfg: ModelConfig) -> int:
    return cfg.n_layers % 3


# ---------------------------------------------------------------------------
# params


def _mlp_shapes(cfg: ModelConfig) -> dict:
    D, F_ = cfg.d_model, cfg.d_ff
    if cfg.activation in ("swiglu", "geglu"):
        return {"w_gate": (D, F_), "w_up": (D, F_), "w_down": (F_, D)}
    return {"w_up": (D, F_), "b_up": (F_,), "w_down": (F_, D), "b_down": (D,)}


def _rec_shapes(cfg: ModelConfig) -> dict:
    D, W = cfg.d_model, rnn_width(cfg)
    return {"ln": {"scale": (D,)}, "w_in": (D, W), "w_gate": (D, W),
            "conv_k": (cfg.conv_width, W), "conv_b": (W,), "lam": (W,),
            "w_a": (W, W), "b_a": (W,), "w_x": (W, W), "b_x": (W,),
            "w_out": (W, D), "ln_mlp": {"scale": (D,)},
            "mlp": _mlp_shapes(cfg)}


def _attn_shapes(cfg: ModelConfig) -> dict:
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    attn = {"wq": (D, H * hd), "wk": (D, Hkv * hd), "wv": (D, Hkv * hd),
            "wo": (H * hd, D)}
    if cfg.qkv_bias:
        attn.update(bq=(H * hd,), bk=(Hkv * hd,), bv=(Hkv * hd,))
    return {"ln": {"scale": (D,)}, "attn": attn, "ln_mlp": {"scale": (D,)},
            "mlp": _mlp_shapes(cfg)}


def _shapes(tree) -> dict:
    """{name: shape or nested dict} of a tree of tensors."""
    return {name: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for name, v in tree.items()}


class Griffin(nn.Module):
    """Parameters of the Griffin LM, from a tree shaped like the reference's
    params dict with ``groups`` as a list of per-group dicts ({"rec1",
    "rec2", "attn"}) and ``tail`` as a list of per-layer dicts.  A leaf the
    port does not know, or of another shape, raises."""

    def __init__(self, cfg: ModelConfig, tree):
        super().__init__()
        check_supported(cfg)
        if cfg.family != "griffin":
            raise ValueError(f"config {cfg.name!r} is of family "
                             f"{cfg.family!r}, not griffin")
        groups, tail = tree["groups"], tree.get("tail", [])
        if len(groups) != n_groups(cfg) or len(tail) != n_tail(cfg):
            raise ValueError(f"{len(groups)} groups and {len(tail)} tail "
                             f"layers for a config of {n_groups(cfg)} and "
                             f"{n_tail(cfg)}")
        group = {"rec1": _rec_shapes(cfg), "rec2": _rec_shapes(cfg),
                 "attn": _attn_shapes(cfg)}
        for i, g in enumerate(groups):
            if _shapes(g) != group:
                raise ValueError(f"group {i} has leaves {_shapes(g)}, not "
                                 f"{group}")
        for j, t in enumerate(tail):
            if _shapes(t) != _rec_shapes(cfg):
                raise ValueError(f"tail layer {j} has leaves {_shapes(t)}, "
                                 f"not {_rec_shapes(cfg)}")
        emb = {"tok": (cfg.padded_vocab, cfg.d_model)}
        if not cfg.tie_embeddings:
            emb["unembed"] = (cfg.d_model, cfg.padded_vocab)
        if _shapes(tree["embed"]) != emb:
            raise ValueError(f"embed has {_shapes(tree['embed'])}, not {emb}")
        if _shapes(tree["final_norm"]) != {"scale": (cfg.d_model,)}:
            raise ValueError(f"final_norm has {_shapes(tree['final_norm'])}")
        self.cfg = cfg
        self.embed = _params(tree["embed"])
        self.final_norm = _params(tree["final_norm"])
        self.groups = nn.ModuleList(_Tree(g) for g in groups)
        self.tail = nn.ModuleList(_Tree(t) for t in tail)

    def param_tree(self) -> dict:
        """The reference's params dict over this module's parameters; each
        leaf under ``"groups"`` is a list of the per-group tensors, each
        under ``"tail"`` one of the tail layers' (no ``"tail"`` without
        tail layers, as in the reference)."""
        tree = {"embed": dict(self.embed.items()),
                "final_norm": dict(self.final_norm.items()),
                "groups": _stack(list(self.groups))}
        if len(self.tail):
            tree["tail"] = _stack(list(self.tail))
        return tree


def _init_norm(cfg: ModelConfig, device):
    return {"scale": torch.zeros((cfg.d_model,), device=device)}


def _init_rec_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    D, W, dev = cfg.d_model, rnn_width(cfg), gen.device
    zeros = torch.zeros((W,), device=dev)
    return {
        "ln": _init_norm(cfg, dev),
        "w_in": dense_init(gen, (D, W)),
        "w_gate": dense_init(gen, (D, W)),
        "conv_k": torch.randn((cfg.conv_width, W), generator=gen,
                              device=dev) * 0.1,
        "conv_b": zeros.clone(),
        "lam": torch.linspace(2.0, 5.0, W, device=dev),   # a in (.88, .99)
        "w_a": dense_init(gen, (W, W)),
        "b_a": zeros.clone(),
        "w_x": dense_init(gen, (W, W)),
        "b_x": zeros.clone(),
        "w_out": dense_init(gen, (W, D), in_axis=0),
        "ln_mlp": _init_norm(cfg, dev),
        "mlp": init_mlp(gen, cfg),
    }


def _init_attn_block(cfg: ModelConfig, gen: torch.Generator) -> dict:
    dev = gen.device
    return {"ln": _init_norm(cfg, dev), "attn": init_attention(gen, cfg),
            "ln_mlp": _init_norm(cfg, dev), "mlp": init_mlp(gen, cfg)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Griffin:
    """Random parameters drawn from ``gen``, on ``gen``'s device."""
    check_supported(cfg)
    groups = [{"rec1": _init_rec_block(cfg, gen),
               "rec2": _init_rec_block(cfg, gen),
               "attn": _init_attn_block(cfg, gen)}
              for _ in range(n_groups(cfg))]
    tail = [_init_rec_block(cfg, gen) for _ in range(n_tail(cfg))]
    tree = {"embed": init_embedding(gen, cfg), "groups": groups,
            "tail": tail, "final_norm": _init_norm(cfg, gen.device)}
    return Griffin(cfg, tree)


# ---------------------------------------------------------------------------
# RG-LRU + conv


def _doubling_scan(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_{-1} = 0, by doubling:
    the pass at offset d composes each step with the one d before it, the
    reference's ``combine`` (a2 a1, a2 b1 + b2); new tensors each pass."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _shift_right(x):
    """x moved one step later along axis 1, zeros first."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


class _LinearScan(torch.autograd.Function):
    """:func:`_doubling_scan` with a backward that is the same scan run
    backwards (g_t = dh_t + a_{t+1} g_{t+1}; da_t = g_t h_{t-1}, db_t =
    g_t) and a forward-mode rule (dh = scan(a, da h_{t-1} + db)), both
    through this function again, so that ``torch.func`` differentiates the
    backward (Sophia-H's HVP is forward-over-reverse).  Autograd keeps a
    and h only."""

    @staticmethod
    def forward(a, b):
        return _doubling_scan(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, _ = inputs
        ctx.save_for_backward(a, output)
        ctx.save_for_forward(a, output)

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
        g = linear_scan(a_next.flip(1), dh.flip(1)).flip(1)
        return g * _shift_right(h), g

    @staticmethod
    def jvp(ctx, da, db):
        a, h = ctx.saved_tensors
        tangent = torch.zeros_like(h) if db is None else db
        if da is not None:
            tangent = da * _shift_right(h) + tangent
        return linear_scan(a, tangent)


def linear_scan(a, b):
    """(B, S, W) coefficients a and inputs b -> h (B, S, W), h_t = a_t
    h_{t-1} + b_t from h_{-1} = 0: a log-depth scan over axis 1 (one
    step, a decode's, is b itself)."""
    if a.shape[1] == 1:
        return b
    return _LinearScan.apply(a, b)


def causal_conv1d(x, kernel, bias, conv_state=None):
    """Depthwise causal conv: x (B, S, W), kernel (cw, W), bias (W,);
    ``conv_state`` (B, cw - 1, W) the previous segment's trailing inputs
    (zeros by default).  Summed tap by tap in x's dtype in the reference's
    order.  Returns (y, new conv state)."""
    cw = kernel.shape[0]
    B, S, W = x.shape
    dt = x.dtype
    if conv_state is None:
        conv_state = x.new_zeros((B, cw - 1, W))
    xp = torch.cat([conv_state.to(dt), x], dim=1)
    k = kernel.to(dt)
    y = xp[:, :S] * k[0]
    for j in range(1, cw):
        y = y + xp[:, j:j + S] * k[j]
    return y + bias.to(dt), xp[:, S:]


def rg_lru(u, r_gate, i_gate, lam, h0=None):
    """u, gates (B, S, W) and lam (W,) in fp32 (or fp64); ``h0`` (B, W) the
    carried state.  Returns (h (B, S, W), h_last (B, W))."""
    log_a = RG_LRU_C * r_gate * -F.softplus(-lam)     # log sigmoid, < 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), 0.0, 1.0)) * (
        i_gate * u)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1]


def rec_block_apply(p, x, cfg: ModelConfig, state=None):
    """One recurrent block: x (B, S, D) -> (x, {"conv", "h"}), from
    ``state`` {"conv" (B, cw - 1, W), "h" (B, W)} (zeros by default).  The
    returned state is a copy, so that it holds no segment-long tensor."""
    dt = x.dtype
    h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    gate = F.gelu(h @ p["w_gate"].to(dt), approximate="tanh")
    u = h @ p["w_in"].to(dt)
    u, new_conv = causal_conv1d(u, p["conv_k"], p["conv_b"],
                                None if state is None else state["conv"])
    f32 = wide(dt)
    u32 = u.to(f32)
    r_gate = torch.sigmoid(u32 @ p["w_a"].to(f32) + p["b_a"].to(f32))
    i_gate = torch.sigmoid(u32 @ p["w_x"].to(f32) + p["b_x"].to(f32))
    y, h_last = rg_lru(u32, r_gate, i_gate, p["lam"].to(f32),
                       None if state is None else state["h"])
    y = (y.to(dt) * gate) @ p["w_out"].to(dt)
    x = x + y
    hm = rms_norm(x, p["ln_mlp"]["scale"], cfg.norm_eps)
    x = x + mlp(p["mlp"], hm, cfg)
    return x, {"conv": new_conv.clone(), "h": h_last.clone()}


def attn_block_apply(p, x, cfg: ModelConfig, attn_impl="auto"):
    """One local-attention block (positions 0..S-1, the config's window)."""
    h = rms_norm(x, p["ln"]["scale"], cfg.norm_eps)
    x = x + train_attention(p["attn"], h, cfg, window=cfg.local_window,
                            impl=attn_impl)
    hm = rms_norm(x, p["ln_mlp"]["scale"], cfg.norm_eps)
    return x + mlp(p["mlp"], hm, cfg)


# ---------------------------------------------------------------------------
# forward / loss


def _stack_states(states) -> dict:
    """[{"conv", "h"}] per layer -> {"conv": (n, ...), "h": (n, ...)}."""
    return {k: torch.stack([s[k] for s in states]) for k in ("conv", "h")}


def forward_hidden(cfg: ModelConfig, params: Griffin, tokens, *,
                   attn_impl: str = "auto", remat: str = "none",
                   last_only: bool = False, final_norm: bool = True):
    """tokens (B, S) -> (hidden (B, S, D), aux, recurrent state): the trunk
    shared by :func:`forward` and the losses.  ``final_norm=False`` returns
    the PRE-norm hidden, which the fused loss normalizes inside its sweep;
    ``last_only`` keeps the last token.  ``aux`` is 0 (fp32).  The state
    is the recurrent layers' after the last token, {"rec1", "rec2",
    ["tail"]} each {"conv", "h"} with a leading layer axis (the slot
    state's leaves without ``kv``).  ``remat="full"`` recomputes each
    group in the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of its group body; the tail is not checkpointed;
    "dots" and "scan2" run as "none", as in the reference."""
    if remat not in REMATS:
        raise ValueError(f"unknown remat {remat!r} (one of {REMATS})")
    x = embed(params.embed, tokens, cfg)

    def group_fn(grp):
        def run(x):
            x, s1 = rec_block_apply(grp["rec1"], x, cfg)
            x, s2 = rec_block_apply(grp["rec2"], x, cfg)
            x = attn_block_apply(grp["attn"], x, cfg, attn_impl)
            return x, s1["conv"], s1["h"], s2["conv"], s2["h"]
        return run

    states = {"rec1": [], "rec2": [], "tail": []}
    for grp in params.groups:
        run = group_fn(grp)
        if remat == "full":
            run = _checkpointed(run, "full")
        x, c1, h1, c2, h2 = run(x)
        states["rec1"].append({"conv": c1, "h": h1})
        states["rec2"].append({"conv": c2, "h": h2})
    for p in params.tail:
        x, s = rec_block_apply(p, x, cfg)
        states["tail"].append(s)
    state = {k: _stack_states(v) for k, v in states.items() if v}
    if last_only:
        x = x[:, -1:]
    if final_norm:
        x = rms_norm(x, params.final_norm["scale"], cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, state


def forward(cfg: ModelConfig, params: Griffin, tokens, *,
            attn_impl: str = "auto", remat: str = "none",
            last_only: bool = False):
    """tokens (B, S) -> (logits (B, S, V) fp32, aux, recurrent state)."""
    x, aux, state = forward_hidden(cfg, params, tokens, attn_impl=attn_impl,
                                   remat=remat, last_only=last_only)
    return unembed(params.embed, x, cfg), aux, state


def loss_fn(cfg: ModelConfig, params: Griffin, batch, *, attn_impl="auto",
            remat="none", loss_impl=None):
    """batch {tokens, labels, [mask]} -> (ce, {"ce", "aux"}), the CE with
    the final RMSNorm fused into the loss route (``pre_norm="rms"``);
    ``aux`` is 0."""
    from .loss import lm_loss
    hidden, aux, _ = forward_hidden(cfg, params, batch["tokens"],
                                    attn_impl=attn_impl, remat=remat,
                                    final_norm=False)
    ce, _ = lm_loss(cfg, params, hidden, batch["labels"], batch.get("mask"),
                    impl=loss_impl, pre_norm="rms")
    return ce, {"ce": ce, "aux": aux}


def sampled_loss_fn(cfg: ModelConfig, params: Griffin, batch, seed, *,
                    attn_impl="auto", remat="none", loss_impl=None, **draws):
    """GNB's sampled-label NLL: ``(nll, n_valid)``, the labels drawn from
    the model's own softmax (``models/loss.py:lm_loss_sampled``)."""
    from .loss import lm_loss_sampled
    hidden, _, _ = forward_hidden(cfg, params, batch["tokens"],
                                  attn_impl=attn_impl, remat=remat,
                                  final_norm=False)
    return lm_loss_sampled(cfg, params, hidden, seed, batch.get("mask"),
                           impl=loss_impl, pre_norm="rms", **draws)


def logits_fn(cfg: ModelConfig, params: Griffin, batch, *, attn_impl="auto",
              **_):
    """The logits (B, S, V) fp32 of ``batch["tokens"]`` (the reference's
    ``logits_fn``, which takes no remat)."""
    return forward(cfg, params, batch["tokens"], attn_impl=attn_impl)[0]


# ---------------------------------------------------------------------------
# serving state


def init_state(cfg: ModelConfig, batch_size: int, device="cpu") -> dict:
    """The zeroed bounded state of ``batch_size`` rows: {"rec1", "rec2",
    ["tail"]} each {"conv" (n, B, cw - 1, W) compute dtype, "h" (n, B, W)
    fp32} and "kv" {"k", "v"} (g, B, local_window, Hkv, hd) compute
    dtype."""
    W, win, g = rnn_width(cfg), cfg.local_window, n_groups(cfg)
    dt = cfg.compute_dtype

    def rec_state(n):
        return {"conv": torch.zeros((n, batch_size, cfg.conv_width - 1, W),
                                    dtype=dt, device=device),
                "h": torch.zeros((n, batch_size, W), dtype=wide(dt),
                                 device=device)}

    shape = (g, batch_size, win, cfg.n_kv_heads, cfg.hd)
    state = {"rec1": rec_state(g), "rec2": rec_state(g),
             "kv": {"k": torch.zeros(shape, dtype=dt, device=device),
                    "v": torch.zeros(shape, dtype=dt, device=device)}}
    if n_tail(cfg):
        state["tail"] = rec_state(n_tail(cfg))
    return state


def init_slots(cfg: ModelConfig, n_slots: int, cache_len: int = 0,
               device="cpu") -> dict:
    """The zeroed state of ``n_slots`` slots (:func:`init_state`);
    ``cache_len`` is ignored: the state is bounded by ``local_window``."""
    if cfg.kv_dtype != "bf16":
        raise ValueError(
            "kv_dtype=int8 targets unbounded paged KV (dense/moe); griffin's "
            f"rolling window is already bounded at {cfg.local_window} tokens")
    return init_state(cfg, n_slots, device)


def _rows(state, index) -> dict:
    """Every leaf of ``state`` indexed on its slot axis (1), as views."""
    return {k: _rows(v, index) if isinstance(v, dict) else v[:, index]
            for k, v in state.items()}


@torch.inference_mode()
def reset_slot(cfg: ModelConfig, state, slot):
    """Zero slot ``slot``'s recurrent state (h and conv) in place; the ring
    KV is left, since its mask hides a finished request's entries."""
    for kind, leaves in state.items():
        if kind != "kv":
            for leaf in leaves.values():
                leaf[:, slot].zero_()
    return state


def _write(leaves, i, new, active):
    """leaves[name][i] <- new[name] in place, only the rows (axis 0 of the
    layer's view) where ``active`` is True when given."""
    for name, leaf in leaves.items():
        upd = new[name]
        if active is not None:
            m = active.reshape((-1,) + (1,) * (upd.dim() - 1))
            upd = torch.where(m, upd, leaf[i])
        leaf[i].copy_(upd)


def _rec_step(p, x, cfg: ModelConfig, leaves, i, active):
    """A recurrent block from its layer's state, written back in place."""
    x, new = rec_block_apply(p, x, cfg, state={k: v[i]
                                               for k, v in leaves.items()})
    _write(leaves, i, new, active)
    return x


def _sweep(cfg: ModelConfig, params: Griffin, state, x, attn_fn, active):
    """The layer loop of one token of every row: ``attn_fn(p_attn, h, i)``
    attends group i's ring.  Returns the logits (N, 1, V) fp32."""
    for i, grp in enumerate(params.groups):
        for kind in ("rec1", "rec2"):
            x = _rec_step(grp[kind], x, cfg, state[kind], i, active)
        blk = grp["attn"]
        x = x + attn_fn(blk["attn"], rms_norm(x, blk["ln"]["scale"],
                                              cfg.norm_eps), i)
        x = x + mlp(blk["mlp"], rms_norm(x, blk["ln_mlp"]["scale"],
                                         cfg.norm_eps), cfg)
    for j, p in enumerate(params.tail):
        x = _rec_step(p, x, cfg, state["tail"], j, active)
    x = rms_norm(x, params.final_norm["scale"], cfg.norm_eps)
    return unembed(params.embed, x, cfg)


@torch.inference_mode()
def decode_slots(cfg: ModelConfig, params: Griffin, state, tokens,
                 positions, active=None):
    """One decode step across all slots: tokens (N, 1), positions (N,) ->
    logits (N, 1, V) fp32.  Each group's attention writes the slot's K/V
    into its ring at ``position % local_window`` and attends the ring
    (``layers.decode_attention_slots``: the decode kernel on the card).
    State is written only where ``active`` (N,) bool is True, when given,
    so that a slot between prefill chunks or free comes out of a decode
    burst unchanged (the reference's ``_select_slots``)."""
    positions = positions.to(torch.int32)
    x = embed(params.embed, tokens, cfg)
    kv = state["kv"]

    def attn_fn(p, h, i):
        return decode_attention_slots(p, h, cfg, {"k": kv["k"][i],
                                                  "v": kv["v"][i]},
                                      positions, active=active)

    return _sweep(cfg, params, state, x, attn_fn, active)


@torch.inference_mode()
def prefill_into_slot(cfg: ModelConfig, params: Griffin, state, slot: int,
                      tokens, start: int, n_valid: int):
    """Chunk-prefill one slot token by token: tokens (1, P), of which the
    first ``n_valid`` are real, at positions start, start + 1, ..., each
    through :func:`decode_slots` on the slot's row (views of the state,
    updated in place).  Returns the logits (V,) fp32 of the last of them
    (zeros when there is none, as the reference's)."""
    row = _rows(state, slice(slot, slot + 1))
    pos = start + torch.arange(max(n_valid, 1), dtype=torch.int32,
                               device=tokens.device)
    logits = torch.zeros((1, 1, cfg.padded_vocab), device=tokens.device)
    for t in range(n_valid):
        logits = decode_slots(cfg, params, row, tokens[:, t:t + 1],
                              pos[t:t + 1])
    return logits[0, -1]


def _rolling_attention(p, x, cfg: ModelConfig, k_cache, v_cache,
                       position: int):
    """MQA decode of every row at one ``position`` over a rolling-window
    cache of the window's size (the reference's ``_rolling_attention``,
    plain PyTorch): k/v written at ``position % window`` in place, fp32
    scores masked where the ring entry's absolute position is negative,
    fp32 softmax cast to x's dtype, then ``w . v`` and the output
    projection."""
    dt = x.dtype
    B = x.shape[0]
    win = cfg.local_window
    pos = torch.full((B, 1), position, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, pos)
    slot = position % win
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    scores = attention_scores_block(q, k_cache, cfg, 1.0 / math.sqrt(cfg.hd))
    s_idx = torch.arange(win, device=x.device)
    abs_pos = position - torch.remainder(position - s_idx, win)
    scores = torch.where((abs_pos >= 0)[None, None, None, None, :], scores,
                         NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    out = torch.einsum("bkgst,btkh->bskgh", w, v_cache)
    out = out.reshape(B, 1, cfg.n_heads * cfg.hd)
    return out @ p["wo"].to(dt)


@torch.inference_mode()
def decode_step(cfg: ModelConfig, params: Griffin, state, tokens,
                position: int):
    """One token of every row at one ``position`` (the lockstep path):
    tokens (B, 1) -> logits (B, 1, V) fp32, the state (:func:`init_state`)
    updated in place; attention is :func:`_rolling_attention`."""
    position = int(position)
    x = embed(params.embed, tokens, cfg)
    kv = state["kv"]

    def attn_fn(p, h, i):
        return _rolling_attention(p, h, cfg, kv["k"][i], kv["v"][i],
                                  position)

    return _sweep(cfg, params, state, x, attn_fn, None)


def _flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def flat_state(state) -> dict:
    """{"rec1/conv": leaf, ...}: the state's leaves by path."""
    return _flat(state)

