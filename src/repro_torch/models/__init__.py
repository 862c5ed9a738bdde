"""The LM substrate's models (the port of ``repro/models``): the config
schema, layer math, attention paths and the dense decoder family."""
