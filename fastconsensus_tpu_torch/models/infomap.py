"""Infomap detector (host C++).

Counterpart of ``fastconsensus_tpu/models/infomap.py``: a two-level
map-equation optimizer with Louvain-style local moves and aggregation
(``native/src/infomap.cpp``, threaded over the ensemble), which has no
data-parallel form.  It crosses to the host exactly as the CNM detector
does (see ``models/cnm.py``).
"""

from __future__ import annotations

from fastconsensus_tpu_torch.models.cnm import make_host_detector

infomap = make_host_detector("infomap_labels")
