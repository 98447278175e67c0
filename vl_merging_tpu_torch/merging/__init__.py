"""The merging suite (port of ``vl_merging_tpu/merging``): host merging
bit-identical to the reference (``core``) and fleet merging on the card
(``device``)."""
