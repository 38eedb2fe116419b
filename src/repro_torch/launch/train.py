"""Training launcher (the twin of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \
        [--steps N] [--global-batch 8] [--seq-len 256] [--ckpt-dir DIR] \
        [--reduced] [--compress] [--lr 3e-4] [--device cuda]

Trains on the card (or the named device) from the newest committed
checkpoint under ``--ckpt-dir`` when one exists, else from random weights
(seed 0); the data stream's position rides in the checkpoint's meta, so a
restarted run continues the same stream.  ``--ckpt-dir`` defaults to
``repro_launch_train`` under the temporary directory (``TMPDIR``).  ``python -m
repro_torch.launch.serve --ckpt-dir DIR`` then serves the trained weights.
"""
import argparse
import os
import tempfile


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_launch_train"))
    ap.add_argument("--reduced", action="store_true", help="CPU-sized config")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.data.lm_data import StreamConfig
    from repro_torch.models.registry import get_model_by_name
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import TrainConfig, Trainer

    model = get_model_by_name(args.arch, reduced=args.reduced, device=args.device)
    scfg = StreamConfig(vocab=model.cfg.vocab, global_batch=args.global_batch, seq_len=args.seq_len, seed=0)
    tcfg = TrainConfig(
        steps=args.steps, ckpt_every=100, ckpt_dir=args.ckpt_dir, log_every=10,
        opt=OptConfig(lr=args.lr, warmup_steps=max(args.steps // 50, 10), total_steps=args.steps,
                      compress=args.compress),
    )
    t = Trainer(model, tcfg, scfg)
    start = t.restore_or_init()
    print(f"[launch.train] {args.arch} from step {start}")
    t.run()


if __name__ == "__main__":
    main()
