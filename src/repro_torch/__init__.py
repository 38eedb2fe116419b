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

Entry points run on the card unless the caller names another device
(``device="cpu"``): the CPU path runs every kernel's plain PyTorch twin.
"""

__all__ = ["connect", "Session", "AdaptConfig", "costmodel"]


def __getattr__(name):
    # lazy: importing the package stays light
    if name in ("connect", "Session"):
        from repro_torch import session as _session

        return getattr(_session, name)
    if name == "AdaptConfig":
        from repro_torch.core.adapt import AdaptConfig

        return AdaptConfig
    if name == "costmodel":
        import importlib

        return importlib.import_module("repro_torch.costmodel")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
