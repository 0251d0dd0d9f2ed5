"""Inputs shared by the port's kernel tests (numpy seeds; no JAX)."""

import math

import numpy as np
import torch

from repro_torch.core import kvcache


def words(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def attention_inputs(seed=30, b=3, h=2, g=4, l=16, feat=40, window=None):
    """Cache-layout inputs: slot 0 idle (all masked), slot 1 a wrapped ring,
    slot 2 part-filled, any further slot full; plane words with every bit
    pattern.  With ``window`` the bias also masks the positions ``window``
    or more behind each slot's current one."""
    rng = np.random.default_rng(seed)
    fw = -(-feat // 32)
    kp, vp = words(rng, (b, l, h, 4, fw)), words(rng, (b, l, h, 4, fw))
    ks = (rng.random((b, l, h)) * 0.5 + 0.01).astype(np.float32)
    vs = (rng.random((b, l, h)) * 0.5 + 0.01).astype(np.float32)
    pos = np.full((b, l), -1)
    ring = np.arange(5, 5 + l)
    pos[1, ring % l] = ring
    pos[2, :7] = np.arange(7)
    pos[3:] = np.arange(l)
    cur = np.array([0, 4 + l, 6] + [l - 1] * (b - 3))
    valid = (pos >= 0) & (pos <= cur[:, None])
    if window is not None:
        valid &= pos > cur[:, None] - window
    bias = np.where(valid, 0.0, -1e30).astype(np.float32)
    bias = np.ascontiguousarray(np.broadcast_to(bias[:, None, None, :], (b, h, g, l)))
    q = torch.from_numpy(rng.normal(size=(b, h, g, feat)).astype(np.float32))
    q_planes, q_scale = kvcache.FusedBitPlaneCacheFormat._query_planes(q)
    return dict(q_planes=q_planes, q_scale=q_scale, kp=kp, ks=ks, vp=vp, vs=vs,
                bias=bias, feat=feat, sm=1.0 / math.sqrt(feat))


