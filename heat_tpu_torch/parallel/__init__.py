"""Multi-device runs: the ("data", "model") mesh of ranks
(``parallel/mesh.py``) and the process group under it
(``parallel/distributed.py``)."""
