"""E2E layer 2's conv at the frontier's shapes, through the library alone:
``F.conv2d`` of the SAME-padded [2, 50, N, N] map with a 1 x N kernel of 20
outputs (the row conv of ``nn/edge_conv.py``), and its autograd backward
for the map (``dgrad``) or the kernel (``wgrad``), f32 and bf16, N = 1024
and 2048, cuDNN's heuristics and its benchmark mode (f32 at N = 2048).
Each piece runs twice in a process of its own, under a 100 s limit (a
piece that does not end is reported as such); the second run's device ms
by CUDA events, the forward included in dgrad and wgrad, and the peak of
allocated memory.  One JSON line a piece:

    python3 benchmarks_torch/e2e_conv_probe.py      # on the card, ~9 min
"""
import json, subprocess, sys, time
if len(sys.argv) > 1:
    import torch
    import torch.nn.functional as F
    n, dt, part, bench = int(sys.argv[1]), getattr(torch, sys.argv[2]), sys.argv[3], sys.argv[4] == "1"
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = bench
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, 50, n, n, device="cuda", generator=g).to(dt).requires_grad_(part == "dgrad")
    w = (0.02 * torch.randn(20, 50, 1, n, device="cuda", generator=g)).to(dt).requires_grad_(part == "wgrad")
    pad = ((n - 1) // 2, n - 1 - (n - 1) // 2)
    def fwd():
        return F.conv2d(F.pad(x, pad), w)
    def run():
        y = fwd()
        if part != "fwd":
            y.backward(torch.ones_like(y))
    run(); torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record(); run(); e.record(); torch.cuda.synchronize()
    print(json.dumps({"n": n, "dtype": sys.argv[2], "part": part, "benchmark": bench, "ms": s.elapsed_time(e),
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    sys.exit(0)
for n in (1024, 2048):
    for dt in ("float32", "bfloat16"):
        for part in ("fwd", "dgrad", "wgrad"):
            for bench in ("0", "1"):
                if bench == "1" and (dt == "bfloat16" or n == 1024):
                    continue
                t = time.time()
                try:
                    r = subprocess.run([sys.executable, __file__, str(n), dt, part, bench], timeout=100,
                                       capture_output=True, text=True)
                    print(r.stdout.strip() or r.stderr.strip()[-300:], f"wall {time.time()-t:.1f}", flush=True)
                except subprocess.TimeoutExpired:
                    print(json.dumps({"n": n, "dtype": dt, "part": part, "benchmark": bench, "timeout_s": 100}), flush=True)
