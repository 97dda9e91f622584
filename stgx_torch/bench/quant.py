"""Int8 post-training quantization of the streaming cells — the port of
``stgx/bench/quant.py``: RT-ST-GCN's and CoST-GCN's FIFO cells, and the
ST-GCN window cell (the window re-run each frame, its centered temporal
conv an im2col of Γ strided slices, taps leading, and one product).

The scheme is the JAX package's:

* **weights**: symmetric per-output-channel int8 (``s_w = max|w| / 127``),
  made once by :func:`quantize_rtstgcn` / :func:`quantize_costgcn` /
  :func:`quantize_stgcn`, in the
  int8 kernels' layout (:func:`stgx_torch.ops.int8_gemm.weight_layout`:
  the same values and bytes as the JAX package's, stored column-major);
* **activations**: symmetric per-tensor int8, with a *dynamic* scale
  measured on the device from the live tensor, or a *static* one from
  :func:`calibrate_scales`;
* the products run on the hand-written kernels of
  :mod:`stgx_torch.ops.int8_gemm`: int8 × int8 summed in int32
  (``int8_gemm``) and rescaled to fp32, the fp32 activation handed to the
  kernel as it is and quantized there under its scale (no quantize pass in
  the cell); in ``"w8"`` mode fp32 activations against the int8 weight
  widened inside the product (``w8_gemm``); CoST-GCN's temporal conv hands
  the kernels its FIFO and dilation (``taps``) instead of a stack of its
  taps; the tiny adjacency contraction stays an fp32 ``einsum``.

Three modes (:func:`quant_mode`): ``"dynamic"``, ``"static"`` (site-keyed
calibrated scales) and ``"w8"``. Static scales are keyed by explicit site
ids (``"fcn_in"``, ``"layers.3.gcn"``, …): a site missing from the
calibration raises ``KeyError``, a calibrated site the cell never consumes
raises ``ValueError`` when the context closes, a site consumed twice in one
step raises ``ValueError``. A static scale reaches the kernels as a 0-d
fp32 tensor on the device, made once per context and device, and a dynamic
one is measured on the device: no step reads a value to the host, so a step
can be captured in a CUDA graph (:func:`stgx_torch.bench.streaming
.measure_quant`). Divisions by a scale stay divisions by a device tensor
(PyTorch turns a division of a CUDA tensor by a host scalar into a product
with the reciprocal, which would change codes).

FIFO state is fp32, bf16 or int8 (``init_*(…, dtype=…)``); int8 state stores
each frame's codes under the static scale of its ``.state`` site (the
CoST-GCN main FIFO under its ``layers.i.tcn`` site, whose taps feed the tcn
product already quantized). A calibration always observes the ``.state``
sites, so one scales dict serves every state dtype. The ST-GCN window
cell's state is its buffer of raw input frames, fp32 or bf16 only (no
calibrated scale exists for raw frames: int8 raises ``ValueError``); a
bf16 buffer's input norm is rounded to bf16, as the JAX cell's is, and
quantized to codes as the JAX cell does it, by a division in bf16
(:func:`_bf16_codes`), before the ``fcn_in`` product reads them (its K = 3
rows only the staged route, which takes no bf16, can read); w8 widens it
to fp32 exactly.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from stgx_torch.models import costgcn
from stgx_torch.models.rtstgcn import frame_norm
from stgx_torch.ops.norms import batch_norm, layer_norm
from stgx_torch.ops.int8_gemm import int8_gemm, quantize_codes, w8_gemm, weight_layout
from stgx_torch.ops.temporal import init_accumulator_state

__all__ = [
    "quantize_weight",
    "int8_matmul",
    "quantize_rtstgcn",
    "quantize_costgcn",
    "quantize_stgcn",
    "quantized_stream_step",
    "quantized_costgcn_stream_step",
    "quantized_stgcn_window",
    "init_quant_stream_state",
    "quantized_size_bytes",
    "calibrate_scales",
    "quant_mode",
    "QUANT_MODELS",
    "MODES",
]

MODES = ("dynamic", "static", "w8")

# The mode of the cells being run. _STATIC: the calibrated {site: scale} of
# a static context; _CONSUMED: the sites the current step has used (reset
# at each step's entry); _OBSERVER: (site, scale) pairs a calibration
# collects; _DEVICE_SCALES: the static scales as 0-d device tensors, by
# (site, device), for the open context.
_MODE = "dynamic"
_STATIC = None
_CONSUMED = None
_OBSERVER = None
_DEVICE_SCALES = {}
_CONST = {}  # (value, device, dtype) -> 0-d tensor


def _const(value: float, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-d constant on ``device``, made once (before any capture)."""
    key = (value, torch.device(device), dtype)
    t = _CONST.get(key)
    if t is None:
        t = _CONST[key] = torch.tensor(value, dtype=dtype, device=device)
    return t


def _abs_max_scale(x) -> torch.Tensor:
    """``max(max|x|, 1e-12) / 127`` as a 0-d fp32 tensor on x's device (a
    bf16 ``x``'s maximum, exact, taken to fp32 first)."""
    return torch.clamp_min(x.abs().amax().float(), 1e-12) / _const(127.0, x.device)


def quantize_weight(w):
    """Per-output-channel (last axis) symmetric int8. Returns ``(w_q, s)``
    in w's layout, on its device."""
    if w.dim() < 2:
        raise ValueError(f"quantize_weight takes a weight of 2 or more axes, got {w.dim()}")
    with torch.no_grad():
        w = w.detach().float()
        s = w.abs().amax(dim=tuple(range(w.dim() - 1))) / _const(127.0, w.device)
        s = torch.clamp_min(s, 1e-12)
        return quantize_codes(w, s), s


@contextlib.contextmanager
def quant_mode(mode: str, scales=None):
    """Mode switch for the cells run inside: ``"dynamic"``, ``"static"``
    (needs the site → scale dict of :func:`calibrate_scales`) or ``"w8"``."""
    global _MODE, _STATIC, _CONSUMED, _DEVICE_SCALES
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r} (have {MODES})")
    if mode == "static" and not isinstance(scales, dict):
        raise ValueError(
            "static mode needs the site-keyed scales dict returned by "
            f"calibrate_scales, got {type(scales).__name__}"
        )
    saved = (_MODE, _STATIC, _CONSUMED, _DEVICE_SCALES)
    _MODE = mode
    _STATIC = {k: float(v) for k, v in scales.items()} if scales is not None else None
    _CONSUMED = None
    _DEVICE_SCALES = {}
    try:
        yield
        _check_static_exhausted()
    finally:
        _MODE, _STATIC, _CONSUMED, _DEVICE_SCALES = saved


def _check_static_exhausted():
    """A finished static step must have consumed every calibrated site but
    the ``.state`` ones (consumed only with int8 FIFO state)."""
    if _MODE == "static" and _CONSUMED:
        missing = {s for s in set(_STATIC) - _CONSUMED if not s.endswith(".state")}
        if missing:
            raise ValueError(
                "static quantization: calibrated sites never consumed by "
                f"the cell (model/calibration mismatch): {sorted(missing)}"
            )


def _static_reset():
    """Called at each streaming cell's entry: a fresh step's site set."""
    global _CONSUMED
    _check_static_exhausted()
    _CONSUMED = set()


def _static_scale(site, device) -> torch.Tensor:
    """Consume and return the calibrated scale of ``site`` (static mode) as
    a 0-d fp32 tensor on ``device``."""
    if site is None:
        raise ValueError("static quantization needs an explicit site id at every "
                         "int8_matmul call")
    if _CONSUMED is not None:
        if site in _CONSUMED:
            raise ValueError(f"quantization site {site!r} consumed twice in one "
                             "step — duplicate site id in the cell")
        _CONSUMED.add(site)
    if site not in _STATIC:
        raise KeyError(
            f"no calibrated scale for site {site!r} — the calibration was taken "
            f"on a different model/config (calibrated sites: {sorted(_STATIC)})"
        )
    key = (site, torch.device(device))
    t = _DEVICE_SCALES.get(key)
    if t is None:
        t = _DEVICE_SCALES[key] = torch.tensor(_STATIC[site], dtype=torch.float32,
                                               device=device)
    return t


def _as_scale(scale, device) -> torch.Tensor:
    if torch.is_tensor(scale):
        return scale
    return torch.tensor(float(scale), dtype=torch.float32, device=device)


def _act_scale(x, scale=None, site=None):
    """The scale an activation is quantized under: the given one, the
    site's static one, or the live abs-max scale of ``x`` (observed by a
    calibration)."""
    if scale is None:
        if _MODE == "static" and _STATIC is not None:
            scale = _static_scale(site, x.device)
        else:
            scale = _abs_max_scale(x)
            if _OBSERVER is not None:
                if site is None:
                    raise ValueError("calibration needs an explicit site id at every "
                                     "int8_matmul call")
                _OBSERVER.append((site, scale))
    else:
        scale = _as_scale(scale, x.device)
    return scale


def int8_matmul(x, w_q, s_w, act_scale=None, site=None, bias=None, taps=None):
    """``x @ w`` with the int8 weight ``(w_q, s_w)``, by the mode.

    dynamic / static: ``x`` and its scale (a live or the site's calibrated
    one) go to ``int8_gemm``, which quantizes ``x`` inside the product; w8:
    ``w8_gemm`` on fp32 ``x``. An int8 ``x`` (int8 FIFO taps feeding the
    product directly) is not quantized and needs ``act_scale``, the scale
    its codes were stored under. ``bias`` is added after the scale, inside
    the kernel's epilogue, in the order the JAX cells add it outside the
    product. ``taps=(gamma, d)``: ``x`` is a FIFO ``(depth, *lead, C)`` and
    the operand its taps ``u[..., tap·C + c] = x[depth − 1 − tap·d, ..., c]``
    (the kernels read them from the FIFO); a live scale is the abs-max of the
    tapped slots.
    """
    if taps is None:
        lead, k = x.shape[:-1], x.shape[-1]
        a = x.reshape(-1, k)
        tapped = a
    else:
        gamma, d = taps
        lead, a = x.shape[1:-1], x
        lo = x.shape[0] - 1 - (gamma - 1) * d
        tapped = x[lo::d] if lo >= 0 else x
    if x.dtype == torch.int8:
        if act_scale is None:
            raise ValueError("pre-quantized int8 input needs its storage act_scale")
        y = int8_gemm(a, w_q, _as_scale(act_scale, x.device), s_w, bias, taps=taps)
    elif _MODE == "w8":
        y = w8_gemm(a, w_q, s_w, bias, taps=taps)
    else:
        y = int8_gemm(a, w_q, _act_scale(tapped, act_scale, site=site), s_w, bias, taps=taps)
    return y.reshape(*lead, w_q.shape[1])


def _bf16_codes(x, site):
    """The int8 codes of a bf16 activation as the JAX cells make them: the
    scale (the site's static one, or ``max|x| / 127`` divided in bf16)
    rounded to bf16 and ``x / scale`` divided in bf16 before it is rounded
    to a code. Returns ``(codes, s)``, ``s`` the fp32 scale the product
    rescales by (the static value as calibrated, or the bf16 live scale)."""
    if _MODE == "static" and _STATIC is not None:
        s = _static_scale(site, x.device)
        d = s.to(torch.bfloat16)
    else:
        d = torch.clamp_min(x.abs().amax(), 1e-12) / _const(127.0, x.device, torch.bfloat16)
        s = d.float()
        if _OBSERVER is not None:
            _OBSERVER.append((site, s))
    return torch.round(x / d).clamp_(-127, 127).to(torch.int8), s


# -- FIFO-state dtype ----------------------------------------------------------


def _observe_state_site(y, site):
    if _OBSERVER is not None:
        _OBSERVER.append((site, _abs_max_scale(y)))


def _fifo_put(y, fifo_dtype, site, observe: bool = True):
    """``(stored, scale)``: the value to store into a FIFO slot, and for
    int8 state the static scale it is stored under (else None).
    ``observe=False`` for a site observed elsewhere in the step (the
    CoST-GCN main FIFO shares its site with the tcn product)."""
    if fifo_dtype == torch.int8:
        if _MODE != "static" or _STATIC is None:
            raise ValueError(
                "int8 FIFO state needs static calibrated scales "
                "(quant_mode('static', calibrate_scales(...))): stored frames "
                "are dequantized at later steps, so a live per-frame scale "
                "would misprice older taps"
            )
        s = _static_scale(site, y.device)
        return quantize_codes(y, s), s
    if observe:
        _observe_state_site(y, site)
    return y.to(fifo_dtype), None


def _quant_acc_step(state, y, kernel: int, stride: int, site, impl: str = "auto"):
    """The RT causal window-sum with the FIFO in the state's dtype: fp32
    as it is, bf16 cast, int8 under the site's static scale. The fresh frame
    enters at full precision; only the K − 1 past taps carry the storage
    rounding, once each. With int8 state the taps sum in int32 (exact), by
    ``impl``: ``"taps"`` stacks the K − 1 past taps, ``"fifo_sum"`` sums
    every s-th FIFO slot (a strided view, no host-built mask) less the slot
    just stored; ``"auto"`` takes ``fifo_sum`` iff K ≥ 16 and B ≥ 8, as the
    JAX cell does. The two give the same bits."""
    k = kernel // stride
    if k <= 1:
        return y, state
    stored, s = _fifo_put(y, state["fifo"].dtype, site)
    fifo = torch.cat([state["fifo"][1:], stored[None]], dim=0)
    depth = fifo.shape[0]
    if s is not None:
        if impl == "auto":
            impl = "fifo_sum" if (k >= 16 and y.shape[0] >= 8) else "taps"
        if impl == "fifo_sum":
            acc = fifo[(depth - 1) % stride::stride].sum(dim=0, dtype=torch.int32)
            acc = acc - stored.to(torch.int32)
        elif impl == "taps":
            taps = [fifo[depth - 1 - i * stride] for i in range(1, k)]
            acc = torch.stack(taps).sum(dim=0, dtype=torch.int32)
        else:
            raise ValueError(f"unknown acc step impl: {impl!r}")
        y_t = y + acc.float() * s
    else:
        taps = [fifo[depth - 1 - i * stride] for i in range(1, k)]
        y_t = y + torch.stack(taps).to(y.dtype).sum(dim=0)
    return y_t, {"fifo": fifo}


# -- RT-ST-GCN -----------------------------------------------------------------


def _kind(model) -> str:
    return type(model.norm_in).__name__  # "LayerNorm" or "BatchNorm"


def _norm_params(norm) -> dict:
    return {"scale": norm.scale.detach().clone(), "bias": norm.bias.detach().clone()}


def _layer_norms(model, layer) -> dict:
    """A layer's norms under flax's names, in creation order (the residual
    1×1 conv's, the graph conv's, the temporal conv's), as the JAX
    ``qparams`` hold them."""
    roles = [r for r in ("res_norm", "norm", "tcn_norm") if hasattr(layer, r)]
    return {f"{_kind(model)}_{i}": _norm_params(getattr(layer, r)) for i, r in enumerate(roles)}


def _qweight(w2d):
    w_q, s = quantize_weight(w2d)
    return weight_layout(w_q), s


def _dense(dense):
    return (*_qweight(dense.kernel), dense.bias.detach().clone())


def quantize_rtstgcn(model):
    """Quantize every matmul weight of an ``RtStgcn``: a qparams dict of
    int8 kernels and their scales, fp32 biases and norm parameters, and the
    folded per-layer adjacency, on the model's device."""
    with torch.no_grad():
        q = {"norm_in": _norm_params(model.norm_in), "layers": [], "fcn_in": _dense(model.fcn_in)}
        for i, layer in enumerate(model.layers):
            gw = layer.gcn.kernel  # (P, C_in, C_out)
            lq = {
                "A": model.layer_A(i).detach().clone(),
                "gcn": (*_qweight(gw.reshape(-1, gw.shape[-1])), layer.gcn.bias.detach().clone()),
                "norms": _layer_norms(model, layer),
            }
            if hasattr(layer, "res_kernel"):
                lq["res"] = _qweight(layer.res_kernel)
            q["layers"].append(lq)
        q["fcn_out"] = _dense(model.fcn_out)
    return q


def _graph_conv(x, layer, site):
    """The int8 graph conv of one frame: the fp32 aggregate over A (an
    einsum), one product over (P·C_in), and the bias carried through A."""
    A = layer["A"]
    agg = torch.einsum("nvc,pvw->nwpc", x, A)  # (N, V, P, C_in)
    wq, sw, gb = layer["gcn"]
    y = int8_matmul(agg.reshape(agg.shape[0], agg.shape[1], -1), wq, sw, site=site)
    return y + torch.einsum("pvw,pd->wd", A, gb)


@torch.no_grad()
def quantized_stream_step(model, qparams, state, x_t):
    """One frame ``(B, V, C_in)`` of B streams through the int8 RT cell
    (the math of ``rtstgcn.stream_step`` with int8 products). Returns
    ``(logits (B, classes), new_state)``."""
    _static_reset()
    kind = _kind(model)
    q = qparams
    x = frame_norm(kind, **q["norm_in"], x_t=x_t, per_joint=True)
    wq, sw, b = q["fcn_in"]
    x = int8_matmul(x, wq, sw, site="fcn_in", bias=b)

    new_state = []
    for i, (layer, lq) in enumerate(zip(model.layers, q["layers"])):
        norms = [lq["norms"][n] for n in sorted(lq["norms"])]
        if not layer.residual:
            res = 0.0
        elif layer.identity:
            res = x
        else:
            rq, rs = lq["res"]
            res = frame_norm(kind, **norms.pop(0),
                             x_t=int8_matmul(x, rq, rs, site=f"layers.{i}.res"))
        y = _graph_conv(x, lq, f"layers.{i}.gcn")
        y, st = _quant_acc_step(state[i], y, model.kernel, model.stride[i],
                                site=f"layers.{i}.state")
        new_state.append(st)
        y = torch.relu(frame_norm(kind, **norms[0], x_t=y))
        x = y + res
        if layer.residual:
            x = torch.relu(x)

    wq, sw, b = q["fcn_out"]
    return int8_matmul(x.mean(dim=1), wq, sw, site="fcn_out", bias=b), new_state


def init_quant_stream_state(model, batch: int = 1, dtype=torch.float32):
    """Empty FIFOs of the int8 RT cell, in ``dtype`` (float32, bfloat16 or
    int8), on the model's device."""
    return [
        init_accumulator_state(batch, model.num_joints, model.out_ch[i], model.kernel,
                               model.stride[i], dtype=dtype, device=model.A.device)
        for i in range(len(model.in_ch))
    ]


# -- CoST-GCN ------------------------------------------------------------------


def quantize_costgcn(model):
    """Quantize every matmul weight of a ``CoStgcn`` (streaming form): as
    :func:`quantize_rtstgcn`, plus the temporal kernel stored pre-flipped
    (tap order, newest first) and reshaped ``(Γ·C, C)``, so that the tap
    contraction is one int8 product; the residual 1×1 conv keeps its bias."""
    with torch.no_grad():
        q = {"norm_in": _norm_params(model.norm_in), "layers": [], "fcn_in": _dense(model.fcn_in)}
        for i, layer in enumerate(model.layers):
            gw = layer.gcn.kernel
            tw = torch.flip(layer.tcn_kernel, dims=(0,))  # (Γ, C, C), tap order
            lq = {
                "A": model.layer_A(i).detach().clone(),
                "gcn": (*_qweight(gw.reshape(-1, gw.shape[-1])), layer.gcn.bias.detach().clone()),
                "tcn": (*_qweight(tw.reshape(-1, tw.shape[-1])), layer.tcn_bias.detach().clone()),
                "norms": _layer_norms(model, layer),
            }
            if hasattr(layer, "res_kernel"):
                lq["res"] = (*_qweight(layer.res_kernel), layer.res_bias.detach().clone())
            q["layers"].append(lq)
        q["fcn_out"] = _dense(model.fcn_out)
    return q


@torch.no_grad()
def quantized_costgcn_stream_step(model, qparams, state, x_t):
    """One frame ``(B, V, C_in)`` of B streams through the int8 CoST-GCN
    cell (the math of ``costgcn.stream_step`` with int8 products; state
    from ``costgcn.init_stream_state``). Returns ``(logits, new_state)``."""
    _static_reset()
    kind = _kind(model)
    gamma = model.kernel
    delay = gamma // 2
    q = qparams
    x = frame_norm(kind, **q["norm_in"], x_t=x_t, per_joint=True)
    wq, sw, b = q["fcn_in"]
    x = int8_matmul(x, wq, sw, site="fcn_in", bias=b)

    new_state = []
    for i, (layer, lq) in enumerate(zip(model.layers, q["layers"])):
        st = state[i]
        d = model.dilation[i]
        norms = [lq["norms"][n] for n in sorted(lq["norms"])]
        res, res_fifo = 0.0, st["res_fifo"]
        if layer.residual:
            if layer.identity:
                res_now = x
            else:
                rq, rs, rb = lq["res"]
                res_now = frame_norm(kind, **norms.pop(0),
                                     x_t=int8_matmul(x, rq, rs, site=f"layers.{i}.res", bias=rb))
            if delay > 0:  # slot 0 holds frame t − Γ//2; shift this frame in
                stored_res, s_res = _fifo_put(res_now, res_fifo.dtype,
                                              site=f"layers.{i}.res.state")
                res = res_fifo[0].float()
                if s_res is not None:
                    res = res * s_res
                res_fifo = torch.cat([res_fifo[1:], stored_res[None]], dim=0)
            else:
                res = res_now

        y = _graph_conv(x, lq, f"layers.{i}.gcn")
        y = torch.relu(frame_norm(kind, **norms[0], x_t=y))
        # the main FIFO's write site is the tcn product's activation site:
        # every tap is a past y, so one calibrated scale covers both; with
        # int8 state the taps feed the product already quantized
        stored, s_fifo = _fifo_put(y, st["fifo"].dtype, site=f"layers.{i}.tcn",
                                   observe=False)
        fifo = torch.cat([st["fifo"][1:], stored[None]], dim=0)
        # the taps u[t − k·d] at slot depth − 1 − k·d, k = 0..Γ−1, in the row
        # order of the pre-flipped (Γ·C, C) kernel, read by the product from
        # the FIFO itself (no stack of them)
        tq, ts, tb = lq["tcn"]
        if s_fifo is not None:
            y = int8_matmul(fifo, tq, ts, act_scale=s_fifo, bias=tb, taps=(gamma, d))
        else:
            y = int8_matmul(fifo, tq, ts, site=f"layers.{i}.tcn", bias=tb, taps=(gamma, d))
        y = frame_norm(kind, **norms[1], x_t=y)
        new_state.append({"fifo": fifo, "res_fifo": res_fifo})
        x = torch.relu(y + res)

    wq, sw, b = q["fcn_out"]
    return int8_matmul(x.mean(dim=1), wq, sw, site="fcn_out", bias=b), new_state


def _init_costgcn_quant_state(model, batch: int = 1, dtype=torch.float32):
    return costgcn.init_stream_state(model, batch=batch, dtype=dtype)


# -- ST-GCN (window classifier) -------------------------------------------------


def quantize_stgcn(model):
    """Quantize every matmul weight of an ``Stgcn`` (window form): as
    :func:`quantize_rtstgcn`, plus the temporal kernel reshaped ``(Γ·C,
    C)`` taps leading (the im2col's column order in
    :func:`_int8_temporal_conv`), and the residual 1×1 conv with its bias."""
    with torch.no_grad():
        q = {"norm_in": _norm_params(model.norm_in), "layers": [], "fcn_in": _dense(model.fcn_in)}
        for i, layer in enumerate(model.layers):
            gw, tw = layer.gcn.kernel, layer.tcn_kernel
            lq = {
                "A": model.layer_A(i).detach().clone(),
                "gcn": (*_qweight(gw.reshape(-1, gw.shape[-1])), layer.gcn.bias.detach().clone()),
                "tcn": (*_qweight(tw.reshape(-1, tw.shape[-1])), layer.tcn_bias.detach().clone()),
                "norms": _layer_norms(model, layer),
            }
            if hasattr(layer, "res_kernel"):
                lq["res"] = (*_qweight(layer.res_kernel), layer.res_bias.detach().clone())
            q["layers"].append(lq)
        q["fcn_out"] = _dense(model.fcn_out)
    return q


def _window_norm(kind, p, x, per_joint: bool = False, mask=None):
    """The eval-mode norm on ``(N, L, V, C)``: batch statistics recomputed
    (no running stats), as the batch form's."""
    if kind == "LayerNorm":
        return layer_norm(x, p["scale"], p["bias"])
    return batch_norm(x, p["scale"], p["bias"], axes=(0, 1) if per_joint else (0, 1, 2),
                      mask=mask)


def _int8_temporal_conv(x, tq, ts, tb, gamma: int, stride: int, site=None):
    """The centered (Γ, 1) temporal conv as an im2col and one int8 product:
    ``out[n, t, v] = Σ_k x_pad[n, t·stride + k, v] · W[k]`` with Γ//2 zero
    frames on each side, the Γ strided slices stacked taps leading so that
    they meet the ``(Γ·C, C)`` kernel's rows in order."""
    n, l, v, c = x.shape
    eff = gamma - 1
    lout = -(-l // stride)
    xp = F.pad(x, (0, 0, 0, 0, eff // 2, eff - eff // 2))
    taps = torch.stack([xp[:, k: k + (lout - 1) * stride + 1: stride] for k in range(gamma)],
                       dim=3)  # (N, L_out, V, Γ, C)
    return int8_matmul(taps.reshape(n, lout, v, gamma * c), tq, ts, site=site, bias=tb)


@torch.no_grad()
def quantized_stgcn_window(model, qparams, x, mask=None):
    """The int8 ST-GCN window forward ``(N, L, V, C_in)`` → ``(N,
    classes)``: the math of ``Stgcn.forward`` in eval mode with every
    product int8 (by the mode), the adjacency an fp32 einsum."""
    _static_reset()
    kind = _kind(model)
    q = qparams
    x = _window_norm(kind, q["norm_in"], x, per_joint=True, mask=mask)
    wq, sw, b = q["fcn_in"]
    if x.dtype == torch.bfloat16 and _MODE != "w8":
        codes, s = _bf16_codes(x, "fcn_in")
        x = int8_matmul(codes, wq, sw, act_scale=s, bias=b)
    else:
        x = int8_matmul(x.float(), wq, sw, site="fcn_in", bias=b)
    for i, (layer, lq) in enumerate(zip(model.layers, q["layers"])):
        stride = layer.stride
        smask = mask[:, ::stride] if mask is not None else None
        norms = [lq["norms"][n] for n in sorted(lq["norms"])]
        if not layer.residual:
            res = 0.0
        elif layer.identity:
            res = x
        else:
            rq, rs, rb = lq["res"]
            res = _window_norm(kind, norms.pop(0), int8_matmul(
                x[:, ::stride], rq, rs, site=f"layers.{i}.res", bias=rb), mask=smask)
        A = lq["A"]
        agg = torch.einsum("nlvc,pvw->nlwpc", x, A)  # (N, L, V, P, C_in)
        wq, sw, gb = lq["gcn"]
        y = int8_matmul(agg.reshape(*agg.shape[:3], -1), wq, sw, site=f"layers.{i}.gcn")
        y = y + torch.einsum("pvw,pd->wd", A, gb)
        y = torch.relu(_window_norm(kind, norms[0], y, mask=mask))
        tq, ts, tb = lq["tcn"]
        y = _int8_temporal_conv(y, tq, ts, tb, model.kernel, stride, site=f"layers.{i}.tcn")
        y = _window_norm(kind, norms[1], y, mask=smask)
        x = torch.relu(y + res)
        mask = smask
    wq, sw, b = q["fcn_out"]
    return int8_matmul(x.mean(dim=(1, 2)), wq, sw, site="fcn_out", bias=b)


def _stgcn_window_qstep(model, qparams, state, x_t):
    """One frame ``(B, V, C_in)`` of B streams through the int8 window cell:
    the buffer rolled by one frame with ``x_t`` last, then
    :func:`quantized_stgcn_window` on it. Returns ``(logits, new_state)``."""
    buf = torch.cat([state["buf"][:, 1:], x_t[:, None].to(state["buf"].dtype)], dim=1)
    return quantized_stgcn_window(model, qparams, buf), {"buf": buf}


def _init_stgcn_quant_state(model, batch: int = 1, dtype=torch.float32, window: int = 50):
    """The empty window buffer ``(B, W, V, C_in)`` in ``dtype`` (float32 or
    bfloat16) on the model's device."""
    if dtype == torch.int8:
        raise ValueError(
            "st-gcn's window buffer holds raw input frames — no calibrated "
            "scale exists for them; use float32/bfloat16 state")
    return {"buf": torch.zeros((batch, window, model.num_joints, model.in_feat), dtype=dtype,
                               device=model.A.device)}


# -- calibration, the registry, sizes -------------------------------------------


@torch.no_grad()
def calibrate_scales(model, qparams, frames, name: str) -> dict:
    """The reference's calibrate pass: run the dynamic cell over ``frames``
    ``(L, V, C)`` at B = 1 and return each site's largest scale as a
    ``{site_id: scale}`` dict for ``quant_mode("static", scales)``.

    The site ids come from one step on a zero frame; a duplicate raises.
    Each site's running maximum stays on the device and is read to the host
    once, at the end."""
    global _OBSERVER
    _, qstep_fn, qinit = QUANT_MODELS[name]
    device = model.A.device
    frames = torch.as_tensor(frames, dtype=torch.float32).to(device)

    def observed_step(state, x_t):
        global _OBSERVER
        _OBSERVER = []
        try:
            _, state = qstep_fn(model, qparams, state, x_t)
            return state, _OBSERVER
        finally:
            _OBSERVER = None

    with quant_mode("dynamic"):  # live scales even inside a static context
        _, obs = observed_step(qinit(model), torch.zeros_like(frames[:1]))
        sites = [s for s, _ in obs]
        dup = {s for s in sites if sites.count(s) > 1}
        if dup:
            raise ValueError(f"duplicate quantization site ids in {name!r}: {sorted(dup)}")
        state = qinit(model)
        mx = torch.zeros(len(sites), dtype=torch.float32, device=device)
        for t in range(frames.shape[0]):
            state, obs = observed_step(state, frames[t][None])
            if [s for s, _ in obs] != sites:
                raise ValueError(f"{name!r}: the cell's sites changed between steps")
            mx = torch.maximum(mx, torch.stack([sc for _, sc in obs]))
        return dict(zip(sites, mx.cpu().tolist()))


class _Registry(dict):
    def __missing__(self, name):
        raise KeyError(f"{name!r} has no quantized streaming cell (have {sorted(self)})")


# model name → (quantize(model), qstep(model, qparams, state, x_t),
# init_state(model, batch, dtype, window)); only st-gcn's buffer is sized by
# the window, the FIFO cells ignore it
QUANT_MODELS = _Registry({
    "rt-st-gcn": (quantize_rtstgcn, quantized_stream_step,
                  lambda model, batch=1, dtype=torch.float32, window=None:
                  init_quant_stream_state(model, batch, dtype)),
    "co-st-gcn": (quantize_costgcn, quantized_costgcn_stream_step,
                  lambda model, batch=1, dtype=torch.float32, window=None:
                  _init_costgcn_quant_state(model, batch, dtype)),
    "st-gcn": (quantize_stgcn, _stgcn_window_qstep, _init_stgcn_quant_state),
})


def _leaves(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def quantized_size_bytes(qparams) -> int:
    """Bytes of every tensor of ``qparams`` (the JAX package's figure: the
    kernel layout replaces the JAX layout, byte for byte)."""
    return sum(t.numel() * t.element_size() for t in _leaves(qparams))
