"""Split one flat call into upload, device compute and download
(counterpart of tools/probe_flat_overhead.py).

At n=56000 and B=65536 queries: the host-to-device copy of the f32 and of
the bf16 queries, the flat top-k kernel K2 on queries already on the card,
the copy of the (B, k) ids back, one call end to end (numpy in, numpy
out), and the call split into 2, 4 and 8 chunks, all enqueued before any
result is read.  Each step is timed by the host clock around work that
ends in a synchronization, best of 3 on fresh queries, and on the card
also by CUDA events around the same work (pageable host memory, as the
engine uploads)::

    python -m expann_tpu_torch.tools.probe_flat_overhead [--n 56000] [--B 65536]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from expann_tpu_torch.bench.harness import sync
from expann_tpu_torch.ops.topk import flat_topk, flat_topk_prepare
from expann_tpu_torch.utils.profiling import card_name

D, K = 128, 10


def best_ms(fn, fresh, device, reps: int = 3) -> tuple:
    """Best of ``reps`` (host ms, device ms or None) of ``fn(fresh())``,
    the host clock and CUDA events both around work that ends in a sync."""
    fn(fresh())
    host, dev = [], []
    for _ in range(reps):
        arg = fresh()
        sync(device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(arg)
        sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
        if device.type == "cuda":
            end.record()
            end.synchronize()
            dev.append(start.elapsed_time(end))
    return min(host), (min(dev) if dev else None)


def main(argv=None, device="cuda") -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=56000)
    ap.add_argument("--B", type=int, default=65536)
    args = ap.parse_args(argv)
    device = torch.device(device)
    card = card_name() if device.type == "cuda" else "cpu"
    n, B = args.n, args.B
    rng = np.random.default_rng(0)
    xf, _ = flat_topk_prepare(rng.standard_normal((n, D)).astype(np.float32), device)

    def fresh():
        return rng.standard_normal((B, D)).astype(np.float32)

    def fresh_dev():
        return torch.from_numpy(fresh()).to(device, torch.bfloat16)

    def run(q):
        return flat_topk(q, xf, K)[0]

    rows = {}
    mb = B * D * 4 / 2**20
    rows["h2d_f32"] = best_ms(lambda h: torch.from_numpy(h).to(device), fresh, device)
    rows["h2d_bf16"] = best_ms(lambda h: h.to(device), lambda: torch.from_numpy(fresh()).to(torch.bfloat16), device)
    rows["device_flat_topk"] = best_ms(run, fresh_dev, device)
    rows["d2h_ids"] = best_ms(lambda ids: ids.cpu().numpy(), lambda: run(fresh_dev()), device)
    rows["e2e_one_call"] = best_ms(lambda h: run(torch.from_numpy(h).to(torch.bfloat16).to(device)).cpu().numpy(),
                                   fresh, device)
    for nchunk in (2, 4, 8):
        cs = B // nchunk

        def chunked(h, cs=cs, nchunk=nchunk):
            outs = [run(torch.from_numpy(h[i * cs : (i + 1) * cs]).to(torch.bfloat16).to(device))
                    for i in range(nchunk)]
            return [o.cpu().numpy() for o in outs]

        rows[f"e2e_{nchunk}x{cs}"] = best_ms(chunked, fresh, device)
    out = {"n": n, "B": B, "k": K, "query_mb_f32": mb, "card": card,
           "steps": {name: {"host_ms": h, "device_ms": d} for name, (h, d) in rows.items()}}
    for name, (h, d) in rows.items():
        qps = f", {B / (h * 1e-3):,.0f} QPS" if name.startswith(("e2e", "device")) else ""
        print(f"{name:18s} host {h:9.2f} ms" + ("" if d is None else f"  events {d:9.2f} ms") + qps, flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
