"""CNM fast-greedy detector (host C++).

Counterpart of ``fastconsensus_tpu/models/cnm.py``.  Greedy agglomeration
is sequential, so both packages run it as first-party host C++
(``native/src/fastgreedy.cpp``, threaded over the ensemble); the
ensemble's randomness is a per-seed node relabeling inside the C++.  The
reference reaches it through ``jax.pure_callback``; here the detector
copies the slab's alive edges to the host, runs the C++ and puts the
labels back on the slab's device.  Only the consensus tail runs on the
card.

Neither host detector takes initial labels or shares keys across members
(no ``supports_init`` / ``supports_align``), so every round runs cold.

In a fused round block (``supports_block``; ``engine.RoundsBlock`` and
``engine.BatchBlock``) the same call runs as the block's host step
(``engine.HostDetect``): on the card a host node of the captured graph
calls the C++ (``native/src/host_detect.cpp``) on pinned copies of the
slab and keys, as the reference's ``jax.pure_callback`` does inside its
jitted block; on the CPU the block calls this detector directly.
``host_fn`` names the native function for it.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fastconsensus_tpu_torch import native
from fastconsensus_tpu_torch.graph import GraphSlab
from fastconsensus_tpu_torch.models.base import Detector
from fastconsensus_tpu_torch.utils import prng


def seeds_from_keys(keys: torch.Tensor) -> np.ndarray:
    """Each member's 64-bit seed from its key's uint32 words, as the
    reference's host callback combines them: ``(w[0] << 32) | w[-1]``."""
    words = prng.key_data(keys).reshape(keys.shape[0], -1).astype(np.uint64)
    return (words[:, 0] << np.uint64(32)) | words[:, -1]


def make_host_detector(fn_name: str) -> Detector:
    """A detector running ``native.<fn_name>`` over the ensemble."""

    def detect(slab: GraphSlab, keys: torch.Tensor,
               init_labels: Optional[torch.Tensor] = None) -> torch.Tensor:
        alive = slab.alive.cpu().numpy()
        src = slab.src.cpu().numpy()[alive].astype(np.int32)
        dst = slab.dst.cpu().numpy()[alive].astype(np.int32)
        weight = slab.weight.cpu().numpy()[alive].astype(np.float32)
        run = getattr(native, fn_name)
        labels = run(src, dst, weight, slab.n_nodes, seeds_from_keys(keys))
        return torch.as_tensor(labels.astype(np.int64), device=slab.device)

    detect.supports_block = True
    detect.host_fn = fn_name
    return detect


cnm = make_host_detector("cnm_labels")
