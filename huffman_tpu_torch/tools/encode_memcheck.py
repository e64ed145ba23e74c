"""encode_lanes on its hard inputs and on the ref profile's row counts,
one launch each, for a memory checker to watch:

    compute-sanitizer --tool memcheck --error-exitcode 1 \\
        python3 -m huffman_tpu_torch.tools.encode_memcheck

The inputs are ``bench.kernel_cases.encode_cases`` at the card's sizes
(tiles staged by 16-byte chunks, offset views whose chunks start before
a row's first byte and end past its last, the direct kernel), each with
every lane's S rows and with random counts of S or S - 1, and the 16 MiB
block laid out at K = 65536 and K = 4096 with its slice sizes, as
``chip_smoke.py`` phase 8 gives them.  With
``PYTORCH_NO_CUDA_MEMORY_CACHING=1`` every tensor is an allocation of its
own, so a read past a tensor's end is a read past an allocation's end.
Correctness against the plain versions is ``chip_smoke.py``'s.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import coding
from ..bench import kernel_cases, workloads
from ..constants import MAX_CODE_LEN, TPU_MAX_CODE_LEN
from ..models.torch_ref_codec import lane_layout
from ..ops.encode import encode_lanes
from ..ops.tables import pack_encode_table


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("encode_memcheck: no CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    runs = []
    for name, c in kernel_cases.encode_cases().items():
        s, k = c["s"], c["k"]
        x = torch.from_numpy(c["data"]).to(dev)[c["offset"] :]
        cc = coding.make_canonical_coding(c["hist"], max_len=TPU_MAX_CODE_LEN, clamp=True)
        tab = torch.from_numpy(pack_encode_table(cc).astype(np.int32)).to(dev)
        rows = torch.from_numpy((s - rng.integers(0, 2, k)).astype(np.int32)).to(dev)
        w32 = (s * TPU_MAX_CODE_LEN + 31) // 32 + 1
        runs.append((f"{name}, S rows", x, tab, s, k, w32, None))
        runs.append((f"{name}, S or S - 1 rows", x, tab, s, k, w32, rows))
    data = torch.from_numpy(workloads.biased_u8(16 << 20, 0)).to(dev)
    cc = coding.make_canonical_coding(coding.histogram(data.cpu().numpy()))
    tab = torch.from_numpy(pack_encode_table(cc).astype(np.int32)).to(dev)
    for k in (65536, 4096):
        lanes, sizes = lane_layout(data, k)
        s = lanes.shape[0]
        w32 = (s * MAX_CODE_LEN + 31) // 32 + 2
        runs.append((f"16 MiB at K={k}, slice sizes", lanes.view(-1), tab, s, k, w32, sizes))
    for label, x, tab, s, k, w32, rows in runs:
        encode_lanes(x, tab, s, k, w32, lane_rows=rows)
        torch.cuda.synchronize()
        print(f"encode_lanes {label}: launched and synchronised", flush=True)


if __name__ == "__main__":
    main()
