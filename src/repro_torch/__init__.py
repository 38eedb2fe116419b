"""PyTorch/CUDA port of the DBFlex engine (``repro``), for NVIDIA Hopper.

The public entry point mirrors ``repro``'s::

    import repro_torch
    from repro_torch.data import tpch
    db = tpch.generate(scale=1.0, seed=7).tables()        # on "cuda"
    session = repro_torch.connect(db)
    result = session.query("q18", threshold=200)
    print(session.report().summary())

Entry points run on the card unless the caller names another device
(``device="cpu"``): the CPU path runs every kernel's plain PyTorch twin.
"""

__all__ = ["connect", "Session"]


def __getattr__(name):
    # lazy: importing the package stays light
    if name in ("connect", "Session"):
        from repro_torch import session as _session

        return getattr(_session, name)
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
