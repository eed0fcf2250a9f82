"""Fused optimizer-engine kernels on flat shards: the counterpart of
``repro/kernels/sophia_update.py``: the Sophia step, the Hessian EMA, the
step with the refresh fused in, AdamW, the AdaHessian step with and
without its refresh, Lion, SignGD and SGD.

The update is elementwise over every parameter: pure memory-bound work.
Each kernel reads its operands once and writes its outputs once.  The
engine (``core/engine.py``, backend ``"fused"``) calls them on whole
dtype-homogeneous flat shards whose length is a multiple of ``block``
(tail-padded once at init), so one launch covers the parameter set.
Compute is fp32; p, m and h (AdamW's and AdaHessian's v) keep their
stored dtype, fp32 or bf16; g and the estimate e are fp32.  Sophia's clip
counts are per ``block`` elements, int32 of shape ``(n // block,)``, as
the reference's grid writes them.

On a CUDA tensor each wrapper launches its hand-written kernel of
``csrc/sophia_update.cu`` and adds one to its count in
``KERNEL_LAUNCHES``:

  wrapper                          count               TPU kernel body, row
  ``sophia_fused_block``           ``sophia_step``     ``_sophia_kernel``, 2
  ``hessian_ema_block``            ``hessian_ema``     ``_hess_ema_kernel``, 3
  ``sophia_refresh_fused_block``   ``sophia_refresh``  ``_sophia_refresh_kernel``,
                                                       4
  ``adahessian_refresh_fused_block``  ``adahessian_refresh``
                                      ``_adahessian_refresh_kernel``, 5
  ``adamw_fused_block``            ``adamw_step``      ``_adamw_kernel``, 6
  ``adahessian_fused_block``       ``adahessian_step`` ``_adahessian_kernel``, 7
  ``lion_fused_block``             ``lion_step``       ``_lion_kernel``, 8
  ``signgd_fused_block``           ``signgd_step``     ``_signgd_kernel``, 9
  ``sgd_fused_block``              ``sgd_step``        ``_sgd_kernel``, 10

On a CPU tensor it computes the plain version beside it (``*_plain``): the
``kernels/ref.py`` math with the per-block counts summed from
``reshape(-1, block)``.  The kernels repeat that math operation for
operation, so on the card a kernel and its plain version agree bit for
bit.  Scalars that change from step to step (lr, the GNB factor B,
AdamW's and AdaHessian's bias corrections from the step count) stay 0-dim
device tensors: no step waits on the host.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import KERNEL_LAUNCHES, _build
from . import ref as kref

BLOCK = 128 * 1024     # the reference's block: clip counts per 128k elements
VEC_ALIGN = 8          # a kernel streams 8 bf16 (or 4 or 8 fp32) a thread
_f32 = torch.float32
_STORED = (torch.float32, torch.bfloat16)


def check_kernel_args(name: str, block: int, **tensors) -> None:
    """Raise ``ValueError`` for anything the kernels do not take: every
    tensor 1-D, contiguous, of one length ``n`` with ``n % block == 0``, on
    one device; p, m, h (v) fp32 or bf16 with m and h of one dtype; g and
    e fp32; ``block`` a positive multiple of 8."""
    if not isinstance(block, int) or block <= 0 or block % VEC_ALIGN:
        raise ValueError(f"{name}: block {block!r} must be a positive "
                         f"multiple of {VEC_ALIGN}")
    first = next(iter(tensors.values()))
    n = first.shape[0] if first.dim() == 1 else None
    for key, t in tensors.items():
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous 1-D "
                             f"tensor, got shape {tuple(t.shape)}")
        if t.shape[0] != n:
            raise ValueError(f"{name}: {key} has {t.shape[0]} elements, "
                             f"not {n}")
        if t.device != first.device:
            raise ValueError(f"{name}: {key} on {t.device}, not "
                             f"{first.device}")
        want = (_f32,) if key in ("g", "e") else _STORED
        if t.dtype not in want:
            raise ValueError(f"{name}: {key} dtype {t.dtype} not in "
                             f"{want}")
    if n % block:
        raise ValueError(f"{name}: n={n} is not a multiple of block="
                         f"{block}")
    state = [tensors[k].dtype for k in ("m", "h", "v") if k in tensors]
    if len(set(state)) > 1:
        raise ValueError(f"{name}: m and h (v) must share one dtype, got "
                         f"{state}")
    if first.device.type == "cuda":
        for key, t in tensors.items():
            if t.data_ptr() % 16:
                raise ValueError(f"{name}: {key} is not 16-byte aligned")
    elif first.device.type != "cpu":
        raise ValueError(f"{name}: no route for device {first.device}")


def _scalar(x, device) -> torch.Tensor:
    """A 0-dim fp32 tensor on ``device`` (lr, B, the step count)."""
    return torch.as_tensor(x, dtype=_f32, device=device).reshape(())


def _per_block(clipped: torch.Tensor, block: int) -> torch.Tensor:
    return clipped.reshape(-1, block).sum(1, dtype=torch.int32)


def _bias_corrections(step, beta1, beta2, device):
    """(bc1, bc2) = 1 - beta**step in fp32 from an fp32 device step, by
    the operations ``kref.adamw_fused_ref`` uses: the kernel reads the
    very values its plain version divides by (CUDA's ``powf`` need not
    match PyTorch's ``pow``)."""
    step = _scalar(step, device)
    return 1.0 - beta1 ** step, 1.0 - beta2 ** step


# ---------------------------------------------------------------------------
# plain versions


def sophia_fused_block_plain(p, m, h, g, lr, *, beta1, gamma, eps,
                             weight_decay, clip_threshold=1.0, block=BLOCK):
    """(p', m', clip counts per block)."""
    p2, m2, clipped = kref.sophia_update_ref(
        p, m, h, g, lr=_scalar(lr, p.device), beta1=beta1, gamma=gamma,
        eps=eps, weight_decay=weight_decay, clip_threshold=clip_threshold)
    return p2, m2, _per_block(clipped, block)


def hessian_ema_block_plain(h, est, *, beta2, scale=1.0, square=False,
                            block=BLOCK):
    """h' = beta2 h + (1-beta2) * scale * est (squared when ``square``),
    in h's dtype."""
    return kref.hessian_ema_ref(h, est, beta2=beta2,
                                scale=_scalar(scale, h.device),
                                square=square)


def sophia_refresh_fused_block_plain(p, m, h, g, e, lr, flag, scale, *,
                                     beta1, beta2, gamma, eps, weight_decay,
                                     clip_threshold=1.0, block=BLOCK):
    """(p', m', h', clip counts per block): when ``flag`` is set, h first
    absorbs ``scale * e``, rounded through its dtype, and the step reads
    the new h; when clear, h passes through."""
    h_sel = (hessian_ema_block_plain(h, e, beta2=beta2, scale=scale)
             if float(flag) > 0.5 else h)
    p2, m2, nclip = sophia_fused_block_plain(
        p, m, h_sel, g, lr, beta1=beta1, gamma=gamma, eps=eps,
        weight_decay=weight_decay, clip_threshold=clip_threshold,
        block=block)
    return p2, m2, h_sel, nclip


def adamw_fused_block_plain(p, m, v, g, lr, step, *, beta1, beta2, eps,
                            weight_decay, block=BLOCK):
    """(p', m', v')."""
    return kref.adamw_fused_ref(p, m, v, g, lr=_scalar(lr, p.device),
                                beta1=beta1, beta2=beta2, eps=eps,
                                weight_decay=weight_decay,
                                step=_scalar(step, p.device))


def adahessian_fused_block_plain(p, m, v, g, lr, step, *, beta1, beta2, eps,
                                 weight_decay, block=BLOCK):
    """(p', m'); v is read only."""
    return kref.adahessian_fused_ref(p, m, v, g, lr=_scalar(lr, p.device),
                                     beta1=beta1, beta2=beta2, eps=eps,
                                     weight_decay=weight_decay,
                                     step=_scalar(step, p.device))


def adahessian_refresh_fused_block_plain(p, m, v, g, e, lr, flag, scale,
                                         step, *, beta1, beta2, eps,
                                         weight_decay, block=BLOCK):
    """(p', m', v'): when ``flag`` is set, v first absorbs ``(scale *
    e)^2``, rounded through its dtype, and the step reads the new v."""
    return kref.adahessian_step_refresh_ref(
        p, m, v, g, e, lr=_scalar(lr, p.device), flag=flag,
        scale=_scalar(scale, p.device), beta1=beta1, beta2=beta2, eps=eps,
        weight_decay=weight_decay, step=_scalar(step, p.device))


def lion_fused_block_plain(p, m, g, lr, *, beta1, beta2, weight_decay,
                           block=BLOCK):
    """(p', m')."""
    return kref.lion_fused_ref(p, m, g, lr=_scalar(lr, p.device),
                               beta1=beta1, beta2=beta2,
                               weight_decay=weight_decay)


def signgd_fused_block_plain(p, m, g, lr, *, beta1, weight_decay,
                             block=BLOCK):
    """(p', m')."""
    return kref.signgd_fused_ref(p, m, g, lr=_scalar(lr, p.device),
                                 beta1=beta1, weight_decay=weight_decay)


def sgd_fused_block_plain(p, m, g, lr, *, momentum, block=BLOCK):
    """(p', m')."""
    return kref.sgd_fused_ref(p, m, g, lr=_scalar(lr, p.device),
                              momentum=momentum)


# ---------------------------------------------------------------------------
# the CUDA kernels


_PTR, _INT, _FLOAT, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                           ctypes.c_longlong)
_SIGNATURES = {
    # pointers, n, block, p_bf16, s_bf16, [flag | square], hypers, stream
    "sophia_step_launch": [_PTR] * 8 + [_LL, _INT, _INT, _INT]
                          + [_FLOAT] * 6 + [_PTR],
    "hessian_ema_launch": [_PTR] * 4 + [_LL, _INT, _INT, _INT]
                          + [_FLOAT] * 2 + [_PTR],
    "sophia_refresh_launch": [_PTR] * 10 + [_LL, _INT, _INT, _INT, _INT]
                             + [_FLOAT] * 8 + [_PTR],
    "adamw_launch": [_PTR] * 8 + [_LL, _INT, _INT, _INT]
                    + [_FLOAT] * 6 + [_PTR],
    "adahessian_step_launch": [_PTR] * 7 + [_LL, _INT, _INT, _INT]
                              + [_FLOAT] * 6 + [_PTR],
    "adahessian_refresh_launch": [_PTR] * 9 + [_LL, _INT, _INT, _INT, _INT]
                                 + [_FLOAT] * 6 + [_PTR],
    # Lion, SignGD, SGD: (b1, 1-b1, b2, 1-b2, wd), unused ones 0
    "lion_launch": [_PTR] * 6 + [_LL, _INT, _INT, _INT] + [_FLOAT] * 5
                   + [_PTR],
    "signgd_launch": [_PTR] * 6 + [_LL, _INT, _INT, _INT] + [_FLOAT] * 5
                     + [_PTR],
    "sgd_launch": [_PTR] * 6 + [_LL, _INT, _INT, _INT] + [_FLOAT] * 5
                  + [_PTR],
}


@functools.cache
def _launch_fn(name: str):
    fn = getattr(_build.load("sophia_update"), name)
    fn.argtypes = _SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def _launch(name: str, count: str, *args) -> None:
    err = _launch_fn(name)(*args)
    if err != 0:
        raise RuntimeError(f"{count} kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES[count] += 1


def _dims(p, s, block):
    return (p.shape[0], block, int(p.dtype == torch.bfloat16),
            int(s.dtype == torch.bfloat16))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptrs(*tensors):
    return tuple(t.data_ptr() for t in tensors)


# ---------------------------------------------------------------------------
# entry points: plain version on the CPU, the kernel on the GPU


def sophia_fused_block(p, m, h, g, lr, *, beta1, gamma, eps, weight_decay,
                       clip_threshold=1.0, block=BLOCK):
    """One Sophia step on flat tensors (length % block == 0): returns (p',
    m', clip counts per block), p' in p's dtype and m' in m's."""
    check_kernel_args("sophia_fused_block", block, p=p, m=m, h=h, g=g)
    kw = dict(beta1=beta1, gamma=gamma, eps=eps, weight_decay=weight_decay,
              clip_threshold=clip_threshold, block=block)
    if p.device.type == "cpu":
        return sophia_fused_block_plain(p, m, h, g, lr, **kw)
    sc = _scalar(lr, p.device).reshape(1)
    p2, m2 = torch.empty_like(p), torch.empty_like(m)
    nclip = torch.zeros((p.shape[0] // block,), dtype=torch.int32,
                        device=p.device)
    _launch("sophia_step_launch", "sophia_step",
            *_ptrs(p, m, h, g, sc, p2, m2, nclip), *_dims(p, m, block),
            beta1, 1.0 - beta1, gamma, eps,
            weight_decay, clip_threshold, _stream(p))
    return p2, m2, nclip


def hessian_ema_block(h, est, *, beta2, scale=1.0, square=False,
                      block=BLOCK):
    """h' = beta2 h + (1-beta2) * scale * est on a flat tensor, squared
    after the scale when ``square`` (the AdaHessian refresh); ``scale``
    (GNB's B) may be a 0-dim device tensor."""
    check_kernel_args("hessian_ema_block", block, h=h, e=est)
    if h.device.type == "cpu":
        return hessian_ema_block_plain(h, est, beta2=beta2, scale=scale,
                                       square=square, block=block)
    sc = _scalar(scale, h.device).reshape(1)
    h2 = torch.empty_like(h)
    _launch("hessian_ema_launch", "hessian_ema",
            *_ptrs(h, est, sc, h2), h.shape[0], block,
            int(h.dtype == torch.bfloat16), int(bool(square)), beta2,
            1.0 - beta2, _stream(h))
    return h2


def sophia_refresh_fused_block(p, m, h, g, e, lr, flag, scale, *, beta1,
                               beta2, gamma, eps, weight_decay,
                               clip_threshold=1.0, block=BLOCK):
    """The Hessian-EMA refresh fused into the Sophia step: one sweep that
    reads h once.  ``flag`` (a host 0/1) selects whether h absorbs ``scale
    * e`` first; ``scale`` may be a 0-dim device tensor.  Returns (p', m',
    h', clip counts per block)."""
    check_kernel_args("sophia_refresh_fused_block", block, p=p, m=m, h=h,
                      g=g, e=e)
    kw = dict(beta1=beta1, beta2=beta2, gamma=gamma, eps=eps,
              weight_decay=weight_decay, clip_threshold=clip_threshold,
              block=block)
    if p.device.type == "cpu":
        return sophia_refresh_fused_block_plain(p, m, h, g, e, lr, flag,
                                                scale, **kw)
    sc = torch.stack([_scalar(lr, p.device), _scalar(scale, p.device)])
    p2, m2, h2 = torch.empty_like(p), torch.empty_like(m), torch.empty_like(h)
    nclip = torch.zeros((p.shape[0] // block,), dtype=torch.int32,
                        device=p.device)
    _launch("sophia_refresh_launch", "sophia_refresh",
            *_ptrs(p, m, h, g, e, sc, p2, m2, h2, nclip),
            *_dims(p, m, block), int(float(flag) > 0.5), beta1,
            1.0 - beta1, beta2, 1.0 - beta2, gamma, eps,
            weight_decay, clip_threshold, _stream(p))
    return p2, m2, h2, nclip


def adamw_fused_block(p, m, v, g, lr, step, *, beta1, beta2, eps,
                      weight_decay, block=BLOCK):
    """One AdamW step on flat tensors: returns (p', m', v').  ``step`` is
    the bias-correction step (the engine's count + 1), a number or a 0-dim
    device tensor."""
    check_kernel_args("adamw_fused_block", block, p=p, m=m, v=v, g=g)
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              block=block)
    if p.device.type == "cpu":
        return adamw_fused_block_plain(p, m, v, g, lr, step, **kw)
    bc1, bc2 = _bias_corrections(step, beta1, beta2, p.device)
    sc = torch.stack([_scalar(lr, p.device), bc1, bc2])
    p2, m2, v2 = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    _launch("adamw_launch", "adamw_step",
            *_ptrs(p, m, v, g, sc, p2, m2, v2), *_dims(p, m, block),
            beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
            weight_decay, _stream(p))
    return p2, m2, v2


def adahessian_fused_block(p, m, v, g, lr, step, *, beta1, beta2, eps,
                           weight_decay, block=BLOCK):
    """One AdaHessian step on flat tensors, v read only (refreshed out of
    band): returns (p', m').  ``step`` is the bias-correction step, a
    number or a 0-dim device tensor."""
    check_kernel_args("adahessian_fused_block", block, p=p, m=m, v=v, g=g)
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              block=block)
    if p.device.type == "cpu":
        return adahessian_fused_block_plain(p, m, v, g, lr, step, **kw)
    bc1, bc2 = _bias_corrections(step, beta1, beta2, p.device)
    sc = torch.stack([_scalar(lr, p.device), bc1, bc2])
    p2, m2 = torch.empty_like(p), torch.empty_like(m)
    _launch("adahessian_step_launch", "adahessian_step",
            *_ptrs(p, m, v, g, sc, p2, m2), *_dims(p, m, block),
            beta1, 1.0 - beta1, beta2, 1.0 - beta2, eps,
            weight_decay, _stream(p))
    return p2, m2


def adahessian_refresh_fused_block(p, m, v, g, e, lr, flag, scale, step, *,
                                   beta1, beta2, eps, weight_decay,
                                   block=BLOCK):
    """The AdaHessian step with the squared-estimate EMA fused in: one
    sweep that reads v once.  ``flag`` (a host 0/1) selects whether v
    absorbs ``(scale * e)^2`` first; ``scale`` and ``step`` may be 0-dim
    device tensors.  Returns (p', m', v')."""
    check_kernel_args("adahessian_refresh_fused_block", block, p=p, m=m,
                      v=v, g=g, e=e)
    kw = dict(beta1=beta1, beta2=beta2, eps=eps, weight_decay=weight_decay,
              block=block)
    if p.device.type == "cpu":
        return adahessian_refresh_fused_block_plain(p, m, v, g, e, lr, flag,
                                                    scale, step, **kw)
    bc1, bc2 = _bias_corrections(step, beta1, beta2, p.device)
    sc = torch.stack([_scalar(lr, p.device), _scalar(scale, p.device), bc1,
                      bc2])
    p2, m2, v2 = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    _launch("adahessian_refresh_launch", "adahessian_refresh",
            *_ptrs(p, m, v, g, e, sc, p2, m2, v2), *_dims(p, m, block),
            int(float(flag) > 0.5), beta1, 1.0 - beta1, beta2, 1.0 - beta2,
            eps, weight_decay, _stream(p))
    return p2, m2, v2


def _momentum_step(launch, count, p, m, g, lr, block, hypers):
    """Lion / SignGD / SGD on the card: (p', m')."""
    sc = _scalar(lr, p.device).reshape(1)
    p2, m2 = torch.empty_like(p), torch.empty_like(m)
    _launch(launch, count, *_ptrs(p, m, g, sc, p2, m2), *_dims(p, m, block),
            *hypers, _stream(p))
    return p2, m2


def lion_fused_block(p, m, g, lr, *, beta1, beta2, weight_decay,
                     block=BLOCK):
    """One Lion step on flat tensors: the sign of the beta1 interpolation
    of the old m and g steps p; m' is the beta2 EMA.  Returns (p', m')."""
    check_kernel_args("lion_fused_block", block, p=p, m=m, g=g)
    if p.device.type == "cpu":
        return lion_fused_block_plain(p, m, g, lr, beta1=beta1, beta2=beta2,
                                      weight_decay=weight_decay, block=block)
    return _momentum_step("lion_launch", "lion_step", p, m, g, lr, block,
                          (beta1, 1.0 - beta1, beta2, 1.0 - beta2,
                           weight_decay))


def signgd_fused_block(p, m, g, lr, *, beta1, weight_decay, block=BLOCK):
    """One momentum SignSGD step on flat tensors: returns (p', m')."""
    check_kernel_args("signgd_fused_block", block, p=p, m=m, g=g)
    if p.device.type == "cpu":
        return signgd_fused_block_plain(p, m, g, lr, beta1=beta1,
                                        weight_decay=weight_decay,
                                        block=block)
    return _momentum_step("signgd_launch", "signgd_step", p, m, g, lr, block,
                          (beta1, 1.0 - beta1, 0.0, 0.0, weight_decay))


def sgd_fused_block(p, m, g, lr, *, momentum, block=BLOCK):
    """One SGD step with heavy-ball momentum, no weight decay: returns
    (p', m')."""
    check_kernel_args("sgd_fused_block", block, p=p, m=m, g=g)
    if p.device.type == "cpu":
        return sgd_fused_block_plain(p, m, g, lr, momentum=momentum,
                                     block=block)
    return _momentum_step("sgd_launch", "sgd_step", p, m, g, lr, block,
                          (momentum, 0.0, 0.0, 0.0, 0.0))


# ---------------------------------------------------------------------------
# bytes of one call (the bound in chip_smoke.py)


def engine_kernel_bytes(name: str, n: int, p_dtype: torch.dtype,
                        state_dtype: torch.dtype, block: int = BLOCK) -> int:
    """Bytes one call must move: each input read once and each output
    written once (p and p' in p's dtype, m, h/v and their outputs in the
    state dtype, g and e fp32, Sophia's int32 clip counts)."""
    bp = torch.empty((), dtype=p_dtype).element_size()
    bs = torch.empty((), dtype=state_dtype).element_size()
    counts = 4 * (n // block)
    momentum = 2 * bp + 2 * bs + 4                      # p m g; p' m'
    per = {"sophia_step": 2 * bp + 3 * bs + 4,          # p m h g; p' m'
           "hessian_ema": 2 * bs + 4,                   # h e; h'
           "sophia_refresh": 2 * bp + 4 * bs + 8,       # p m h g e; p' m' h'
           "adamw_step": 2 * bp + 4 * bs + 4,           # p m v g; p' m' v'
           "adahessian_refresh": 2 * bp + 4 * bs + 8,   # p m v g e; p' m' v'
           "adahessian_step": 2 * bp + 3 * bs + 4,      # p m v g; p' m'
           "lion_step": momentum, "signgd_step": momentum,
           "sgd_step": momentum}
    extra = counts if name in ("sophia_step", "sophia_refresh") else 0
    return n * per[name] + extra
