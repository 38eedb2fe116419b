"""Language models (the twin of ``repro.models``): the dense decoder, its
layers, the registry and the conversion of the reference's parameters."""
