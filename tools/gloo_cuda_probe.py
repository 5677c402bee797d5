"""Which gloo collectives take CUDA tensors, on this machine's torch.

    PYTHONPATH=src python3 tools/gloo_cuda_probe.py      # on the card

Starts two ranks that share the card over gloo (the port's launcher) and
calls each collective the port's mesh uses once on CUDA tensors, checking
the result; prints one JSON object {collective: "ok" | the error}.
Every one passed (torch 2.11.0+cu128 on an H100), so the port's
collectives take CUDA tensors under gloo as they are and none is staged
through host memory.  The checkpoint's gather to rank 0 is not probed: under
gloo it sends host tensors, since host memory is where the leaves go.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def probe() -> dict:
    import torch
    import torch.distributed as dist
    rank, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.full((4, 3), float(rank + 1), device=dev)
    out = {}

    def case(name, fn, want):
        try:
            got = fn()
            torch.cuda.synchronize()
            ok = torch.equal(got.cpu(), want)
            out[name] = "ok" if ok else f"wrong result {got.cpu().tolist()}"
        except Exception as e:          # the probe records every refusal
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    def all_reduce(op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return torch.cat(parts)

    def all_gather_into_tensor():
        y = torch.empty((4 * n, 3), device=dev)
        dist.all_gather_into_tensor(y, x)
        return y

    def reduce_scatter_tensor():
        y = torch.empty((4 // n, 3), device=dev)
        dist.reduce_scatter_tensor(y, x.clone())
        return y

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        return y

    total = float(sum(range(1, n + 1)))
    case("all_reduce", lambda: all_reduce(dist.ReduceOp.SUM),
         torch.full((4, 3), total))
    case("all_reduce_max", lambda: all_reduce(dist.ReduceOp.MAX),
         torch.full((4, 3), float(n)))
    case("all_gather", all_gather,
         torch.cat([torch.full((4, 3), float(r + 1)) for r in range(n)]))
    case("all_gather_into_tensor", all_gather_into_tensor,
         torch.cat([torch.full((4, 3), float(r + 1)) for r in range(n)]))
    case("reduce_scatter_tensor", reduce_scatter_tensor,
         torch.full((4 // n, 3), total))
    case("broadcast", broadcast, torch.full((4, 3), 1.0))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.launch import mesh as mesh_lib
    # Two ranks on one card: backend_for picks gloo.
    res = mesh_lib.spawn(probe, 2, device="cuda", threads=0, timeout_s=300)
    print(json.dumps({"backend": "gloo", "torch": torch.__version__,
                      "rank0": res[0], "rank1": res[1]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
