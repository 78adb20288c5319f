"""K3 (row gather) and K5 (banded matvec) timed on the card for one tree of
the port, per call and on the device alone, beside their library calls.

    python3 tools/gather_banded_times.py [PACKAGE_ROOT] [--reps N]

Prints one JSON line per measurement:

- the launch floor: the device time of one tiny PyTorch launch
  (``t.add_(1)`` on a one-element tensor), queued as every "device" time
  here is (chip_smoke.py's `device_ms`: the calls wait behind a sleeping
  kernel, so the host's time per call drops out);
- K3 `gather_rows` at each of chip_smoke.py's `k3_inputs` (the shapes and
  views the panel LU passes it), int32 indices as the panel factor gives
  them: per call (`cuda_ms`) and on the device, beside advanced indexing
  (``src[batch, idx]``, the library call) timed both ways;
- K5 `banded_matvec_padded` at the Krylov phase's shape (N=34,225,
  bw=13, M=2) with float32 x, and through `BandedAffineOperator.bind` on
  the Krylov pencil with float64 x, as the BiCGSTAB loop calls it, beside
  CSR SpMM.

Only the API that every tree of the port has is used, so PACKAGE_ROOT
(default: this checkout; put first on the import path) may be an older
tree unpacked with `git archive <commit> morfem_tpu_torch`: run trees in
turns in one call (parent, change, change, parent) to compare them on one
card. The inputs and timers come from this checkout's chip_smoke.py.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", nargs="?", default=str(HERE))
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    sys.path.insert(0, args.root)

    import torch

    import morfem_tpu_torch
    from morfem_tpu_torch.ops.banded_matvec import BandedAffineOperator
    from morfem_tpu_torch.ops.kernels import (
        banded_matvec_padded, gather_rows,
    )

    if not torch.cuda.is_available():
        print("gather_banded_times: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    reps = args.reps
    head = {"package": str(Path(morfem_tpu_torch.__file__).parent),
            "device": torch.cuda.get_device_name(0)}

    def emit(**rec):
        print(json.dumps(dict(head, **rec)), flush=True)

    emit(what="launch_floor", device_ms=smoke.launch_floor_ms(dev))

    gen = torch.Generator(device=dev).manual_seed(0)
    for label, src, idx, _ in smoke.k3_inputs(dev, gen):
        out = gather_rows(src, idx)
        batch = torch.arange(src.shape[0], device=dev)[:, None]
        idx64 = idx.long()
        exact = torch.equal(out, src[batch, idx64])
        emit(what="K3", case=label, shape=list(src.shape),
             rows=idx.shape[1], exact=exact,
             ms=smoke.cuda_ms(lambda: gather_rows(src, idx), reps),
             device_ms=smoke.device_ms(lambda: gather_rows(src, idx), reps),
             library_ms=smoke.cuda_ms(lambda: src[batch, idx64], reps),
             library_device_ms=smoke.device_ms(lambda: src[batch, idx64],
                                               reps))
        del src, idx, out

    n, half, m = smoke.P_34K ** 2, 6, 2
    bw = 2 * half + 1
    band = torch.randn((n, bw), generator=gen, device=dev)
    x = torch.randn((n, m), generator=gen, device=dev)
    csr = smoke._band_csr(band, half)
    emit(what="K5", case="bare f32 x", n=n, bw=bw, m=m,
         ms=smoke.cuda_ms(lambda: banded_matvec_padded(band, n, bw, half, x),
                          reps),
         device_ms=smoke.device_ms(
             lambda: banded_matvec_padded(band, n, bw, half, x), reps),
         library_ms=smoke.cuda_ms(lambda: csr @ x, reps),
         library_device_ms=smoke.device_ms(lambda: csr @ x, reps))
    op = BandedAffineOperator(*smoke.krylov_pencil(n), device=dev)
    mv = op.bind(torch.tensor([1.0, 0.0, 2.25], dtype=torch.float64,
                              device=dev))
    x64 = torch.randn((n, m), generator=gen, device=dev,
                      dtype=torch.float64)
    y = mv(x64)
    emit(what="K5", case="bind, f64 x", n=n, bw=op.bw, m=m,
         out_dtype=str(y.dtype), ms=smoke.cuda_ms(lambda: mv(x64), reps),
         device_ms=smoke.device_ms(lambda: mv(x64), reps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
