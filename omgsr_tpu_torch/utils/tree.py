"""Pytree-path utilities.

Model parameters in this framework are nested dicts whose key paths mirror
the HF checkpoint key structure (e.g. ``down_blocks.0.attentions.1.to_q``).
That makes these subsystems trivial and robust:

  * weight porters (safetensors key -> dict path is near-identity),
  * LoRA injection by module-name matching (the reference targets torch
    module names like "to_q"/"conv1", train/train_omgsr_s.py:60-115 — here
    the same match runs on dict paths),
  * sharding annotation by path regex.

The port's own copy of the two functions it needs.
"""

from __future__ import annotations


def flatten_dict(d, prefix=()):
    """Nested dict -> {tuple_path: leaf}."""
    out = {}
    for k, v in d.items():
        p = prefix + (k,)
        if isinstance(v, dict):
            out.update(flatten_dict(v, p))
        else:
            out[p] = v
    return out


def unflatten_dict(flat):
    """{tuple_path: leaf} -> nested dict."""
    out = {}
    for path, v in flat.items():
        cur = out
        for k in path[:-1]:
            cur = cur.setdefault(k, {})
        cur[path[-1]] = v
    return out
