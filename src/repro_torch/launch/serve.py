"""Serving launcher (the twin of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --requests 16 --slots 4 [--reduced] [--device cpu] [--ckpt-dir DIR]

Restores the parameters of the newest committed checkpoint under
``--ckpt-dir`` when one exists (``python -m repro_torch.launch.train``
writes them; the optimizer state beside them is not read), otherwise
initializes random weights from seed 0 at the architecture's published
widths (demo mode); casts them to bfloat16, runs the continuous-batching
decode loop on the card (or the named device) and prints aggregate
throughput.
"""
import argparse
import time


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.models import common
    from repro_torch.models.registry import get_model_by_name
    from repro_torch.serve.serve_loop import Request, Server
    from repro_torch.train import checkpoint as ckpt

    model = get_model_by_name(args.arch, reduced=args.reduced, device=args.device)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        tree, meta = ckpt.restore(args.ckpt_dir, {"params": model.init_shapes()}, device=model.device)
        params = tree["params"]
        print(f"[serve] restored step {meta['step']} from {args.ckpt_dir}")
    else:
        # bf16 as drawn, leaf by leaf: the float32 draw is never held whole
        params = model.init(torch.Generator(device=model.device).manual_seed(0), dtype=torch.bfloat16)
        print("[serve] no checkpoint — random weights (demo mode)")
    # serving runs bf16 weights, as the reference does
    params = common.cast_tree(params, torch.bfloat16)

    srv = Server(
        model, params, batch_slots=args.slots, cache_len=args.cache_len,
        eos=-1, temperature=args.temperature,
    )
    for i in range(args.requests):
        srv.submit(Request(rid=i, prompt=[1 + i % 7, 2, 3], max_new=args.max_new))
    t0 = time.perf_counter()
    with torch.no_grad():
        done = srv.run_until_done()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out) for r in done)
    print(
        f"[serve] {len(done)} requests, {toks} tokens, {dt:.2f}s "
        f"({toks/dt:.1f} tok/s aggregate over {args.slots} slots, "
        f"{srv.steps_run} decode steps)"
    )


if __name__ == "__main__":
    main()
