"""The distributed layer of the port (``repro.distributed``): the
sharding policy, the collectives the serving path runs, FSDP x TP training
(``fsdp``), activation hints (``hints``) and the pipeline (``pipeline``)."""
