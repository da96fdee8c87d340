"""Serving launcher: batched greedy decoding over synthetic requests (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \
        --requests 8 --max-new 16 [--device cpu]

The arguments are the reference's, plus ``--device`` (the card unless
``cpu`` is named). As in the reference, ``--reduced`` is always on, the
weights come from seed 0 (here a ``torch.Generator``) and the prompts from
``np.random.default_rng(0)``: 4-23 tokens each. A reduced SSM or hybrid
config chunks its SSD by 16, and the reference asserts that a prompt longer
than a chunk is a whole number of chunks, so its own launcher stops at the
first 21-token prompt; the port raises ``ValueError`` there, and runs with
``REPRO_TORCH_OPT_SSM_CHUNK=32`` (the reference: ``REPRO_OPT_SSM_CHUNK=32``).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.sharding.specs import Topology


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api = build_model(cfg)
    params = api.init(torch.Generator().manual_seed(0), device=args.device)
    eng = ServeEngine(
        api, params, Topology(mesh=None),
        batch_size=args.batch_size, max_len=args.max_len, device=args.device,
    )
    rng = np.random.default_rng(0)
    reqs = []
    for rid in range(args.requests):
        plen = int(rng.integers(4, 24))
        r = Request(
            rid=rid,
            prompt=rng.integers(2, cfg.vocab_size, size=plen).astype(np.int32),
            max_new_tokens=args.max_new,
        )
        reqs.append(r)
        eng.submit(r)
    t0 = time.perf_counter()
    eng.run_until_drained()
    dt = time.perf_counter() - t0
    total = sum(len(r.generated) for r in reqs)
    print(f"served {len(reqs)} requests / {total} tokens in {dt:.2f}s "
          f"({total/dt:.1f} tok/s batched greedy)")
    for r in reqs[:4]:
        print(f"  req {r.rid}: {len(r.generated)} tokens {r.generated[:8]}...")


if __name__ == "__main__":
    main()
