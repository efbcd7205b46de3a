#!/usr/bin/env python3
"""Phase 4's phi3.5-moe-42b serve of ``chip_smoke.py`` (8 of 32 layers,
full width, bf16, paged, dropless, 8 prompts of 64-1024 tokens, 32 new
each), timed on two checkouts in turns on one card.

    python3 tools/phi_serve_ab.py OTHER [--pairs 2]

``OTHER`` is the root of another checkout (for example the parent commit
unpacked with ``git archive`` into a directory ``.gitignore`` lists).  The
serve runs in a fresh process a turn, from the root of its checkout and
with that checkout's ``chip_smoke.py`` and ``src``, in the order other,
this, this, other, repeated ``--pairs`` times.  Each process builds the
kernels, loads the weights (seed 0), serves once to warm up, then twice on
fresh engines (an empty prefix index) on the same weights, then runs
``chip_smoke.phase_profile``'s window.  It prints one ``[ab]`` JSON line a
process (ms a step, ITL, TTFT and tok/s of each timed serve; the window's
idle share and device busy ms) and, last, the medians of each side.
Needs one CUDA card; exits 3 without one.
"""

from __future__ import annotations

import json
import os
import pathlib
import statistics
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parents[1]


def child(label: str) -> int:
    """One turn, in the checkout that is the working directory."""
    sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = ""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("phi_serve_ab: no CUDA device available", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from repro_torch.serving.api import LLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line, _ = cs.phase_card(torch)
    cs.phase_build()
    cfg = cs._cut("phi3.5-moe-42b", 8)
    rng = np.random.default_rng(2)           # phase 4's prompts
    shared = rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).astype(np.int32)
    prompts = ([np.concatenate([shared, tail(100)])]
               + [tail(n) for n in (64, 1024, 300)]
               + [np.concatenate([shared, tail(n)]) for n in (40, 250, 480)]
               + [tail(700)])
    per_step = {"flash_chunk_paged": 8, "topk_gate": 8, "permute_tokens": 8,
                "unpermute_tokens": 8, "grouped_gemm": 24}
    llm = cs._load(torch, cs.phi_spec(), cfg, line)
    runs = []
    for i in range(3):
        if i:
            params = llm.params
            del llm
            cs.free_memory(torch)
            llm = LLM.from_spec(cs.phi_spec(), cfg=cfg, params=params,
                                device="cuda", dtype=torch.bfloat16)
            del params
        out = cs._serve(torch, llm, prompts, 32, per_step, line,
                        f"{label} serve {i}")
        if i:                                # serve 0 is the warm-up
            runs.append({"ms_step": out["wall_s"] / out["steps"] * 1e3,
                         "itl_ms": out["itl_ms"], "ttft_ms": out["ttft_ms"],
                         "tok_s": out["tok_s"], "steps": out["steps"]})
    prof = cs.phase_profile(torch, llm, rng, label)
    print("[ab] " + json.dumps({"side": label, "card": line, "runs": runs,
                                "idle_share": prof["idle_share"],
                                "busy_ms": prof["busy_ms"]}))
    return 0


def main(argv: list) -> int:
    if argv[:1] == ["--child"]:
        return child(argv[1])
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else 2
    got: dict = {"other": [], "this": []}
    for side in ["other", "this", "this", "other"] * pairs:
        tree = other if side == "other" else HERE
        p = subprocess.run([sys.executable, str(HERE / "tools" /
                                                "phi_serve_ab.py"),
                            "--child", side], cwd=str(tree),
                           capture_output=True, text=True, timeout=900)
        print(p.stdout[-4000:], end="")
        if p.returncode:
            print(p.stderr[-4000:], file=sys.stderr)
            return p.returncode
        got[side].append(json.loads(p.stdout.splitlines()[-1][5:]))
    summary = {}
    for side, recs in got.items():
        runs = [r for rec in recs for r in rec["runs"]]
        summary[side] = {
            "ms_step": statistics.median(r["ms_step"] for r in runs),
            "itl_ms": statistics.median(r["itl_ms"] for r in runs),
            "ttft_ms": statistics.median(r["ttft_ms"] for r in runs),
            "idle_share": statistics.median(r["idle_share"] for r in recs),
            "busy_ms": statistics.median(r["busy_ms"] for r in recs)}
    print(json.dumps({"medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
