"""T5 v1.1 encoder (google/t5-v1_1-xxl layout): FLUX's second text tower.

The reference gets T5-XXL sequence embeddings through
FluxPipeline.encode_prompt (train/train_omgsr_f.py:244-251). Parameter paths
mirror the HF keys under ``encoder.*`` plus the shared token embedding; the
embedding table and the relative-position table stay (rows, width) as HF
stores them. ``init_t5_encoder`` lives in ``convert/params.py``.

T5's quirks are kept: RMSNorm without mean subtraction, no attention scaling
(scale 1.0), the relative position bias of block 0 shared by every layer,
and a gated feed-forward with tanh-approximated GELU. The attention takes a
bias, so it is the explicit matmul attention (``ops/attention.
matmul_attention``), which is what the JAX package leaves to XLA at this
site: no flash kernel runs here.
"""

from __future__ import annotations

import numpy as np
import torch

from omgsr_tpu_torch.models.configs import T5Config
from omgsr_tpu_torch.models.layers import dense, gelu, rms_norm
from omgsr_tpu_torch.ops.attention import matmul_attention


def _relative_position_bucket(relative_position, num_buckets=32, max_distance=128):
    """Bidirectional T5 bucketing (transformers' T5Attention), in numpy as
    the JAX package computes it."""
    num_buckets //= 2
    ret = (relative_position > 0).astype(np.int64) * num_buckets
    n = np.abs(relative_position)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(n.clip(min=1) / max_exact) / np.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


def t5_position_bias(params, cfg: T5Config, seq_len: int) -> torch.Tensor:
    """(1, heads, q_len, k_len) additive attention bias from block 0's table."""
    ctx = np.arange(seq_len)[:, None]
    mem = np.arange(seq_len)[None, :]
    buckets = _relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance)
    table = params["encoder"]["block"]["0"]["layer"]["0"]["SelfAttention"]["relative_attention_bias"]["weight"]
    bias = table[torch.from_numpy(buckets).to(table.device)]  # (q, k, heads)
    return bias.permute(2, 0, 1)[None]


def t5_encode(params, cfg: T5Config, input_ids, attention_mask=None):
    """input_ids (B, S) -> encoder hidden states (B, S, d_model) in the
    weights' dtype; attention_mask (B, S), where given, masks the keys at 0."""
    table = params["shared"]["weight"]
    input_ids = torch.as_tensor(input_ids, device=table.device).long()
    x = table[input_ids]
    bias = t5_position_bias(params, cfg, x.shape[1]).float()
    if attention_mask is not None:
        keep = torch.as_tensor(attention_mask, device=x.device)[:, None, None, :] > 0
        bias = bias + torch.where(keep, 0.0, torch.finfo(torch.float32).min)

    inner = cfg.num_heads * cfg.d_kv
    for i in sorted(params["encoder"]["block"], key=int):
        blk = params["encoder"]["block"][i]["layer"]
        ap = blk["0"]["SelfAttention"]
        h = rms_norm(blk["0"]["layer_norm"], x, cfg.layer_norm_epsilon)
        b, s, _ = h.shape
        q, k, v = (dense(ap[n], h).reshape(b, s, cfg.num_heads, cfg.d_kv) for n in ("q", "k", "v"))
        o = matmul_attention(q, k, v, bias=bias, scale=1.0)
        x = x + dense(ap["o"], o.reshape(b, s, inner))

        fp = blk["1"]["DenseReluDense"]
        h = rms_norm(blk["1"]["layer_norm"], x, cfg.layer_norm_epsilon)
        h = gelu(dense(fp["wi_0"], h), approximate=True) * dense(fp["wi_1"], h)
        x = x + dense(fp["wo"], h)

    return rms_norm(params["encoder"]["final_layer_norm"], x, cfg.layer_norm_epsilon)
