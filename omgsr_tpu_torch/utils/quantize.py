"""Weight-only int8 / int4 storage of dense layers, and the w8a8 marker.

Purpose: FLUX.1-dev's 11.9B-parameter DiT is 23.8 GB in bf16. Symmetric int8
codes with a per-output-channel f32 scale halve that to 11.9 GB; int4 codes
(two per byte) with a scale per group of 128 input channels bring it to
about 6.3 GB. The frozen base of -F training and the served DiT can then
leave room on the card for everything else.

Layout (torch, like every leaf of the port): a dense module's ``weight``
(out, in) becomes

  * ``weight_q`` int8 (out, in) and ``weight_scale`` f32 (out,), or
  * ``weight_q4`` uint8 (out, in/2), codes in [-7, 7] stored at an offset of
    8, two per byte along the in axis (low nibble first), and
    ``weight_scale`` f32 (out, in/g) per group of g = 128 input channels where
    g divides in, else (out,) per channel;

plus, for the w8a8 route, an ``act_quant`` marker (an int8 scalar).
``models.layers.dense`` reads these dicts: weight-only codes are dequantised
to the activation dtype at the call (multiplied in f32, then cast); a marked
module quantises its input per token and multiplies int8 by int8 into int32
(``torch._int_mm``). The JAX package's names are ``kernel_q`` /
``kernel_q4`` / ``kernel_scale`` over (in, out); ``convert/params.py``
carries trees across.

Quantise AFTER the LoRA merge (adapters fold into the float base first);
LoRA attached on top of a quantised base still applies in ``dense``. The
port keeps one dict per FLUX block (no scan-stacked layout), so the tree is
quantised tensor by tensor: ``quantize_flux_for_serving`` moves one float
tensor at a time to the target device and keeps only its codes there, and
``init_flux_quantized`` draws each block and quantises it before the next.
A 2-D ``weight`` is taken for a dense layer's: the trees quantised here are
the DiT's, which hold no embedding table.
"""

from __future__ import annotations

import torch

from omgsr_tpu_torch.utils.devices import resolve_device

# in-dim group size of int4 (the JAX package's default: GPTQ/AWQ-style g = 128)
INT4_GROUP_SIZE = 128

# Subtrees whose dense layers stay weight-only even with act_quant: the AdaLN
# modulation and the embedders see one row per sample (no product worth an
# int8 route) and their outputs steer every token.
W8A8_EXCLUDE = frozenset({"norm", "norm1", "norm1_context", "norm_out", "time_text_embed"})


def quantize_kernel_int8(w: torch.Tensor):
    """(..., out, in) float weight -> (int8 codes, f32 per-out-channel scale (..., out))."""
    w32 = w.to(torch.float32, copy=True)  # worked on in place: one f32 copy beside the weight
    scale = (w32.abs().amax(dim=-1) / 127.0).clamp_min(1e-12)
    q = w32.div_(scale[..., None]).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def quantize_kernel_int4(w: torch.Tensor, group_size: int | None = INT4_GROUP_SIZE):
    """(..., out, in) float weight -> (uint8 codes packed two per byte along
    the in axis (..., out, in/2), f32 scale (..., out, in/g) when
    ``group_size`` divides in (and is smaller), else (..., out)). Scale =
    absmax / 7, codes in [-7, 7] stored at an offset of 8. Needs an even in dim."""
    w32 = w.to(torch.float32, copy=True)  # worked on in place
    in_dim = w32.shape[-1]
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even in dim, got {tuple(w32.shape)}")
    if group_size and in_dim % group_size == 0 and in_dim > group_size:
        wg = w32.reshape(*w32.shape[:-1], in_dim // group_size, group_size)
        scale = (wg.abs().amax(dim=-1) / 7.0).clamp_min(1e-12)  # (..., out, in/g)
        q = wg.div_(scale[..., None]).round_().clamp_(-7, 7).add_(8.0).reshape(w32.shape)
    else:
        scale = (w32.abs().amax(dim=-1) / 7.0).clamp_min(1e-12)  # (..., out)
        q = w32.div_(scale[..., None]).round_().clamp_(-7, 7).add_(8.0)  # [1, 15]
    q = q.to(torch.uint8)
    return q[..., 0::2] | (q[..., 1::2] << 4), scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 (..., out, in/2) -> int8 codes (..., out, in) in [-7, 7], low nibble first."""
    lo = (packed & 0x0F).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], 2 * packed.shape[-1])


def dequantize_weight(p, dtype) -> torch.Tensor:
    """A dense module's weight (out, in) in ``dtype``, from its float
    ``weight`` or its codes. Codes times scale are multiplied in f32 and the
    product is cast once (a bf16 scale would add 0.2-0.4% of error per
    channel), in one pass over the codes: the product's type is f32 and the
    output's ``dtype``."""
    if "weight" in p:
        return p["weight"].to(dtype)
    scale = p["weight_scale"]
    w = unpack_int4(p["weight_q4"]) if "weight_q4" in p else p["weight_q"]
    out = torch.empty(w.shape, dtype=dtype, device=w.device)
    if scale.dim() == w.dim():  # group-wise (out, in/g): each group scale over its g input channels
        groups = scale.shape[-1]
        w = w.reshape(*w.shape[:-1], groups, w.shape[-1] // groups)
        torch.mul(w, scale[..., None], out=out.view(w.shape))
        return out
    return torch.mul(w, scale[..., None], out=out)


def quantize_tree_int8(tree, min_params: int = 1 << 16, act_quant: bool = False, bits: int = 8,
                       group_size: int | None = INT4_GROUP_SIZE, place=None):
    """A new tree with every dense ``weight`` (2-D, floating, at least
    ``min_params`` elements) replaced by its codes and scale; conv weights
    (4-D), norms, biases and LoRA factors stay. The codes are computed where
    the weight lies; ``place`` (a callable on each leaf, e.g. a move to a
    device) is applied to every float leaf before and to every code after.

    act_quant=True also marks each quantised module outside ``W8A8_EXCLUDE``
    subtrees with ``act_quant``, the w8a8 route of ``layers.dense``
    (inference only); an already weight-only tree gains the marker, and an
    int4 tree refuses it. bits=4 stores int4 (an odd in dim falls back to
    int8)."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    if bits == 4 and act_quant:
        raise ValueError("act_quant (w8a8) requires int8 codes; use bits=8")
    place = place or (lambda x: x)

    def marker(like):
        return torch.zeros((), dtype=torch.int8, device=like.device)

    def rec(node, excluded):
        if not isinstance(node, dict):
            return place(node)
        w = node.get("weight")
        if isinstance(w, torch.Tensor) and w.dim() == 2 and w.numel() >= min_params and w.is_floating_point():
            w = place(w)
            q4 = bits == 4 and w.shape[-1] % 2 == 0
            q, scale = quantize_kernel_int4(w, group_size) if q4 else quantize_kernel_int8(w)
            del w
            # the siblings too: a sub-dict beside a large weight must not stay unquantised
            out = {k: rec(v, excluded or k in W8A8_EXCLUDE) for k, v in node.items() if k != "weight"}
            out["weight_q4" if q4 else "weight_q"] = q
            out["weight_scale"] = scale
            if act_quant and not excluded:
                out["act_quant"] = marker(q)
            return out
        if act_quant and "weight_q4" in node:
            raise ValueError("act_quant requested on an int4-quantized weight: int4 is a train-memory mode; "
                             "requantize the float base at bits=8 for w8a8")
        out = {k: rec(v, excluded or k in W8A8_EXCLUDE) for k, v in node.items()}
        if act_quant and not excluded and "weight_q" in node and "act_quant" not in node:
            # a tree quantised weight-only earlier: w8a8 must still add the marker
            out["act_quant"] = marker(out["weight_q"])
        return out

    return rec(tree, False)


def quantize_tree_int4(tree, min_params: int = 1 << 16, group_size: int | None = INT4_GROUP_SIZE, place=None):
    """``quantize_tree_int8`` at bits=4: nibble-packed weight-only storage."""
    return quantize_tree_int8(tree, min_params=min_params, bits=4, group_size=group_size, place=place)


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def quantize_flux_for_serving(flux_params, act_quant: bool = False, bits: int = 8, min_params: int = 1 << 16,
                              group_size: int | None = INT4_GROUP_SIZE, device="cuda"):
    """A (ported, LoRA-merged) FLUX tree quantised with its codes on
    ``device``: each float tensor is moved there alone, quantised, and
    dropped, so the device never holds more than one float weight beside the
    codes (a tree already on ``device`` is read where it lies). act_quant
    marks the w8a8 route; bits=4 packs int4."""
    device = resolve_device(device)
    return quantize_tree_int8(flux_params, min_params=min_params, act_quant=act_quant, bits=bits,
                              group_size=group_size, place=lambda x: x.to(device))


def init_flux_quantized(seed, cfg, dtype=torch.bfloat16, device="cuda", act_quant: bool = False, bits: int = 8,
                        min_params: int = 1 << 16, group_size: int | None = INT4_GROUP_SIZE):
    """Random FLUX parameters (``convert.params.init_flux``'s draws, in its
    order) in quantised form on ``device``: each block (and each top-level
    part) is drawn in ``dtype`` and quantised before the next is drawn, so
    the float tree never exists whole. Equal to quantising ``init_flux(seed,
    cfg, dtype, device)``."""
    from omgsr_tpu_torch.convert.params import init_flux

    def finish(name, part):
        return quantize_tree_int8({name: part}, min_params=min_params, act_quant=act_quant, bits=bits,
                                  group_size=group_size)[name]

    return init_flux(seed, cfg, dtype, device, finish=finish)
