"""Traffic generators, one module a kind; the mixes are the ``*.json`` files
beside them, each naming its generator."""
