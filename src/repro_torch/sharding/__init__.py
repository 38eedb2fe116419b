"""LM sharding on the port's single-controller mesh (the twin of
``repro.sharding``): logical rules and placement (``partition``), the
parameter / state / batch / cache layouts (``params``) and the ring
all-gather matmul (``overlap``)."""
