"""Wire dtypes of the result dict and their host-side widening (the
host half of tpumap/utils/fetch.py; its device packer is not needed).
"""
from __future__ import annotations

import numpy as np

# Wire dtypes for result-dict fields: the fields travel to the host in
# these narrow types, and the driver widens them back to int32 right
# after the copy (widen_ints) so host numpy never sees a narrow unsigned
# type.
_WIRE_DTYPES = {
    "strand": "uint8", "nmismatch": "uint16", "second_nmismatch": "uint16",
    "n_best": "uint16", "trim_qstart": "uint16", "trim_qend": "uint16",
    "trim_nmm": "uint16", "qual_mean16": "uint16",
    "in_idx": "int32", "in_startoff": "int16",
    "pe_cs1": "uint8", "pe_cs2": "uint8",
    "pe_cn1": "uint16", "pe_cn2": "uint16",
    "pe_ci": "uint8", "pe_cj": "uint8",
}


def widen_ints(d: dict) -> dict:
    """Host-side inverse: upcast narrow ints to int32 so downstream numpy
    arithmetic can never wrap (uint16 - int, -1 sentinels, etc.)."""
    out = {}
    for k, v in d.items():
        if (isinstance(v, np.ndarray)
                and v.dtype in (np.uint8, np.uint16, np.int16, np.int8)):
            out[k] = v.astype(np.int32)
        else:
            out[k] = v
    return out


