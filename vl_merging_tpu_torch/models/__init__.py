"""VL-MoME model: spec, relative-position bias, layers, blocks, towers."""
