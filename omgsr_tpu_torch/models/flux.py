"""FLUX.1-dev DiT (FluxTransformer2DModel): pure apply functions over a
parameter tree whose key paths mirror the HF safetensors keys
(transformer_blocks.0.attn.to_q, single_transformer_blocks.7.proj_mlp, ...).

x_embedder over packed 2x2 latents, 19 dual-stream and 38 single-stream
blocks, joint text-image attention with 3-axis RoPE over (txt_ids, img_ids)
and per-head QK RMS norms, AdaLayerNorm-Zero modulation from the timestep,
guidance and pooled-CLIP embeddings. The sequence of the joint attention is
laid out [text; image], as in diffusers' FluxAttnProcessor. Timestep and
guidance enter as sigmas in [0, 1] and are scaled by 1000 before the
sinusoidal projection (diffusers' FluxTransformer2DModel.forward).

The blocks run as a Python loop, eagerly. With ``cfg.remat_blocks`` (training
under gradient checkpointing) each block runs under
``torch.utils.checkpoint``: the backward keeps one carry a block and
recomputes the block's internals, as the JAX package's scan-stacked DiT does
under ``jax.checkpoint`` per block. Every attention goes through
``ops/attention.dot_product_attention``, so at head dim 128 the joint
attention is the flash-attention kernel on the card; RoPE, the RMS norms, the
modulation and GELU are plain tensor code.

Multi-GPU (``parallel/sharding.shard_flux_params``): with a ``sharding``
every block's FSDP chunks are all-gathered just before the block runs and
dropped after it, and under tensor parallelism each rank runs its share of
the heads and of the MLP width: the column-parallel products stay local, and
each row-parallel product (the attention outputs, the MLP down projections,
the single blocks' ``proj_out``) is summed over the tensor-parallel group.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from omgsr_tpu_torch.models.configs import FluxConfig
from omgsr_tpu_torch.models.layers import dense, layer_norm, rms_norm, silu, timestep_embedding
from omgsr_tpu_torch.ops.attention import dot_product_attention


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------


def rope_cos_sin(ids: torch.Tensor, axes_dims, theta: int = 10000):
    """ids (S, n_axes) -> (cos, sin), each (S, sum(axes_dims) // 2) in f32.

    Per axis a of dim d: freqs_j = theta^(-2j/d) for j < d/2, computed in
    float64 and used as float32; angle = pos_a * freqs_j in float32
    (diffusers' FluxPosEmbed)."""
    outs_cos, outs_sin = [], []
    for a, d in enumerate(axes_dims):
        half = d // 2
        freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float64) * 2.0 / d))
        angle = ids[:, a].float()[:, None] * freqs.to(device=ids.device, dtype=torch.float32)[None, :]
        outs_cos.append(torch.cos(angle))
        outs_sin.append(torch.sin(angle))
    return torch.cat(outs_cos, dim=-1), torch.cat(outs_sin, dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D) with D = 2 * cos.shape[-1]; rotates interleaved pairs
    (a, b) -> (a*c - b*s, b*c + a*s) in f32, cast back to x's dtype."""
    b, s, h, d = x.shape
    xf = x.float().reshape(b, s, h, d // 2, 2)
    a, bb = xf[..., 0], xf[..., 1]
    c = cos[None, :, None, :]
    sn = sin[None, :, None, :]
    out = torch.stack([a * c - bb * sn, bb * c + a * sn], dim=-1)
    return out.reshape(b, s, h, d).to(x.dtype)


# ----------------------------------------------------------------------------
# apply
# ----------------------------------------------------------------------------


def _mlp_embedder(p, x):
    return dense(p["linear_2"], silu(dense(p["linear_1"], x)))


def _time_text_embed(p, cfg: FluxConfig, timestep, guidance, pooled, dtype):
    t_proj = timestep_embedding(timestep * 1000.0, 256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
    emb = _mlp_embedder(p["timestep_embedder"], t_proj.to(dtype))
    if cfg.guidance_embeds:
        g_proj = timestep_embedding(guidance * 1000.0, 256, flip_sin_to_cos=True, downscale_freq_shift=0.0)
        emb = emb + _mlp_embedder(p["guidance_embedder"], g_proj.to(dtype))
    return emb + _mlp_embedder(p["text_embedder"], pooled.to(dtype))


def _modulate(x, shift, scale):
    return layer_norm(None, x, eps=1e-6) * (1 + scale[:, None, :]) + shift[:, None, :]


def _heads(x, n):
    b, s, d = x.shape
    return x.reshape(b, s, n, d // n)


def _local_heads(cfg: FluxConfig, sh) -> int:
    return cfg.num_attention_heads // (sh.tp_size if sh is not None else 1)


def _row(sh):
    """The row-parallel reduction of ``dense``: the sharding under tensor
    parallelism, else None (a plain product)."""
    return sh if sh is not None and sh.tp_group is not None else None


def _joint_attention(p, cfg: FluxConfig, img, txt, cos, sin, sh=None):
    n = _local_heads(cfg, sh)
    q = rms_norm(p["norm_q"], _heads(dense(p["to_q"], img), n))
    k = rms_norm(p["norm_k"], _heads(dense(p["to_k"], img), n))
    v = _heads(dense(p["to_v"], img), n)
    tq = rms_norm(p["norm_added_q"], _heads(dense(p["add_q_proj"], txt), n))
    tk = rms_norm(p["norm_added_k"], _heads(dense(p["add_k_proj"], txt), n))
    tv = _heads(dense(p["add_v_proj"], txt), n)
    # sequence layout: [text; image]
    q = apply_rope(torch.cat([tq, q], dim=1), cos, sin)
    k = apply_rope(torch.cat([tk, k], dim=1), cos, sin)
    v = torch.cat([tv, v], dim=1)
    o = dot_product_attention(q, k, v)
    b, s, h, d = o.shape
    o = o.reshape(b, s, h * d)
    t_len = txt.shape[1]
    return dense(p["to_out"]["0"], o[:, t_len:], _row(sh)), dense(p["to_add_out"], o[:, :t_len], _row(sh))


def _dual_block(p, cfg: FluxConfig, img, txt, temb, cos, sin, sh=None):
    if sh is not None:
        p = sh.gather(p)
    act = silu(temb)
    sh_msa, sc_msa, g_msa, sh_mlp, sc_mlp, g_mlp = dense(p["norm1"]["linear"], act).chunk(6, dim=-1)
    c_sh_msa, c_sc_msa, c_g_msa, c_sh_mlp, c_sc_mlp, c_g_mlp = dense(p["norm1_context"]["linear"], act).chunk(
        6, dim=-1)

    img_attn, txt_attn = _joint_attention(
        p["attn"], cfg, _modulate(img, sh_msa, sc_msa), _modulate(txt, c_sh_msa, c_sc_msa), cos, sin, sh)

    img = img + g_msa[:, None, :] * img_attn
    h = F.gelu(dense(p["ff"]["net"]["0"]["proj"], _modulate(img, sh_mlp, sc_mlp)), approximate="tanh")
    img = img + g_mlp[:, None, :] * dense(p["ff"]["net"]["2"], h, _row(sh))

    txt = txt + c_g_msa[:, None, :] * txt_attn
    ch = F.gelu(dense(p["ff_context"]["net"]["0"]["proj"], _modulate(txt, c_sh_mlp, c_sc_mlp)), approximate="tanh")
    txt = txt + c_g_mlp[:, None, :] * dense(p["ff_context"]["net"]["2"], ch, _row(sh))
    return img, txt


def _single_block(p, cfg: FluxConfig, x, temb, cos, sin, sh=None):
    if sh is not None:
        p = sh.gather(p)
    n = _local_heads(cfg, sh)
    shift, scale, gate = dense(p["norm"]["linear"], silu(temb)).chunk(3, dim=-1)
    xn = _modulate(x, shift, scale)
    q = rms_norm(p["attn"]["norm_q"], _heads(dense(p["attn"]["to_q"], xn), n))
    k = rms_norm(p["attn"]["norm_k"], _heads(dense(p["attn"]["to_k"], xn), n))
    v = _heads(dense(p["attn"]["to_v"], xn), n)
    o = dot_product_attention(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v)
    b, s, h, d = o.shape
    mlp = F.gelu(dense(p["proj_mlp"], xn), approximate="tanh")
    # under tensor parallelism proj_out's input columns are this rank's heads, then its MLP slice
    out = dense(p["proj_out"], torch.cat([o.reshape(b, s, h * d), mlp], dim=-1), _row(sh))
    return x + gate[:, None, :] * out


def flux_apply(params, cfg: FluxConfig, hidden_states, timestep, guidance, pooled_projections,
               encoder_hidden_states, txt_ids, img_ids, sharding=None):
    """hidden_states (B, S_img, 64) packed latents, timestep / guidance sigmas
    in [0, 1] (scalars or (B,)), pooled (B, 768), encoder_hidden_states
    (B, S_txt, 4096), txt_ids (S_txt, 3), img_ids (S_img, 3) -> the velocity
    prediction (B, S_img, 64) in the input's dtype. ``sharding``: the
    ``parallel.sharding.Sharding`` of a tree that ``shard_flux_params``
    placed (every rank of its groups makes the same call)."""
    dtype, device = hidden_states.dtype, hidden_states.device
    blocks = {k: params[k] for k in ("transformer_blocks", "single_transformer_blocks")}
    if sharding is not None:  # the leaves outside the blocks, gathered once a forward
        params = sharding.gather({k: v for k, v in params.items() if k not in blocks})
    img = dense(params["x_embedder"], hidden_states)
    txt = dense(params["context_embedder"], encoder_hidden_states)

    b = img.shape[0]
    timestep = torch.as_tensor(timestep, dtype=torch.float32, device=device).expand(b)
    if guidance is not None:
        guidance = torch.as_tensor(guidance, dtype=torch.float32, device=device).expand(b)
    temb = _time_text_embed(params["time_text_embed"], cfg, timestep, guidance, pooled_projections, dtype)

    cos, sin = rope_cos_sin(torch.cat([txt_ids, img_ids], dim=0).to(device), cfg.axes_dims_rope, cfg.rope_theta)

    dual, single = _dual_block, _single_block
    if cfg.remat_blocks:
        def dual(*args):
            return checkpoint(_dual_block, *args, use_reentrant=False)

        def single(*args):
            return checkpoint(_single_block, *args, use_reentrant=False)

    for i in sorted(blocks["transformer_blocks"], key=int):
        img, txt = dual(blocks["transformer_blocks"][i], cfg, img, txt, temb, cos, sin, sharding)
    x = torch.cat([txt, img], dim=1)
    for i in sorted(blocks["single_transformer_blocks"], key=int):
        x = single(blocks["single_transformer_blocks"][i], cfg, x, temb, cos, sin, sharding)
    img = x[:, txt.shape[1]:]

    # AdaLayerNormContinuous: the chunk order is (scale, shift)
    scale, shift = dense(params["norm_out"]["linear"], silu(temb)).chunk(2, dim=-1)
    return dense(params["proj_out"], layer_norm(None, img, eps=1e-6) * (1 + scale[:, None, :]) + shift[:, None, :])
