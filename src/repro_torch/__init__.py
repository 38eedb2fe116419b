"""PyTorch/CUDA port of the DBFlex engine (``repro``), for NVIDIA Hopper.

The public entry point mirrors ``repro``'s::

    import repro_torch
    from repro_torch.data import tpch
    db = tpch.generate(scale=1.0, seed=7).tables()        # on "cuda"
    session = repro_torch.connect(db)
    result = session.query("q18", threshold=200)
    print(session.report().summary())

The installation stage learns the card's own dictionary cost model Δ::

    model = repro_torch.costmodel.install()               # profile, train, store
    session = repro_torch.connect(db, delta=model)

Adaptive planning races near-cost plans on warm-up traffic and serves the
measured winner::

    session = repro_torch.connect(db, adapt=repro_torch.AdaptConfig(top_k=3))

Sharded execution row-shards lineitem and orders over N shards, each on
a card (all on one card where there is one)::

    session = repro_torch.connect(db, shards=4)

LM training (dense decoders) runs through ``repro_torch.train``::

    from repro_torch.data.lm_data import StreamConfig
    from repro_torch.models.registry import get_model_by_name
    model = get_model_by_name("llama3.2-3b")
    trainer = repro_torch.train.Trainer(model, repro_torch.train.TrainConfig(steps=100),
                                        StreamConfig(model.cfg.vocab, global_batch=8, seq_len=256))
    trainer.run()

Entry points run on the card unless the caller names another device
(``device="cpu"``): the CPU path runs every kernel's plain PyTorch twin.
"""

__all__ = ["connect", "Session", "AdaptConfig", "costmodel", "train"]


def __getattr__(name):
    # lazy: importing the package stays light
    if name in ("connect", "Session"):
        from repro_torch import session as _session

        return getattr(_session, name)
    if name == "AdaptConfig":
        from repro_torch.core.adapt import AdaptConfig

        return AdaptConfig
    if name in ("costmodel", "train"):
        import importlib

        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
