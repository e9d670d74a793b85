"""Transform serving on the PyTorch/CUDA port: many clients, mixed sizes,
one coalescing service.

A handful of async clients submit square FFT requests of different
sizes and kinds (complex ``lb`` and real ``rfft-lb``) to one
``FFTService``.  The tick loop coalesces every same-``(n, dtype,
method)`` request waiting at tick time into a single batch-stacked
dispatch, the bounded plan cache (fronting the wisdom store) keeps each
cohort's plan hot, and admission is priced by the cost model — an
oversized request is refused with the model's prediction attached
instead of stalling everyone behind it.

Run on the GPU:  PYTHONPATH=src python examples/serve_fft_demo_torch.py
or on the host:  PYTHONPATH=src python examples/serve_fft_demo_torch.py --device cpu
"""

import argparse
import asyncio
import os
import tempfile

import numpy as np
import torch

from repro_torch.launch.serve_fft import AdmissionError, FFTService

rng = np.random.default_rng(0)


def make_request(n, method):
    if method.startswith("rfft"):
        return rng.standard_normal((n, n)).astype(np.float32)
    return (rng.standard_normal((n, n))
            + 1j * rng.standard_normal((n, n))).astype(np.complex64)


async def client(name, svc, n, method):
    m = make_request(n, method)
    out = await svc.submit(m, method=method)
    x = torch.from_numpy(m)
    ref = torch.fft.rfft2(x) if method.startswith("rfft") else torch.fft.fft2(x)
    ok = torch.allclose(torch.as_tensor(out).cpu(), ref, atol=1e-2)
    print(f"  {name}: n={n:3d} {method:8s} -> {tuple(out.shape)} "
          f"{'matches torch.fft' if ok else 'MISMATCH'}")
    return ok


async def main(device):
    wisdom = os.path.join(tempfile.mkdtemp(), "wisdom.json")
    svc = FFTService(wisdom=wisdom, tune="estimate", tick_budget_s=0.05,
                     device=device)

    # One deliberately oversized request: priced rejection, not a stall.
    try:
        svc.enqueue(np.zeros((4096, 4096), np.complex64), method="lb")
    except AdmissionError as e:
        print(f"oversized request refused: {e}")

    # A burst of mixed-size clients served concurrently.
    jobs = [(32, "lb"), (32, "lb"), (32, "rfft-lb"), (64, "lb"),
            (64, "rfft-lb"), (32, "lb"), (128, "lb"), (64, "lb")]
    async with svc:
        results = await asyncio.gather(
            *(client(f"client{i}", svc, n, meth)
              for i, (n, meth) in enumerate(jobs)))
    assert all(results)

    s = svc.stats()
    print(f"\nserved {s['served']} requests in {s['dispatches']} dispatches "
          f"({s['batching_efficiency']:.1f} requests/dispatch, "
          f"largest cohort {s['max_coalesced']})")
    print(f"plan cache: {s['plan_cache']}")
    print(f"plan sources: {s['sources']} "
          f"(a second service on this wisdom store would be all 'wisdom')")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device; default: the CUDA device")
    asyncio.run(main(parser.parse_args().device))
