"""Test-support harnesses that ship with the library: deterministic fault
injection (``repro_torch.testing.faults``) at the engine's named points,
and one real device out-of-memory served by the ladder
(``repro_torch.testing.oom``)."""
