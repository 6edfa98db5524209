"""The distributed layer of the port (``repro.distributed``): the
sharding policy and the collectives the serving path runs."""
