"""The port's counterpart of ``mxnet_tpu/ir``: only ``tune.fit_buckets`` so
far (the serving bucket fit ``ModelServer.retune_buckets`` applies). The
graph IR (``graph.py``, ``lower.py``, ``passes.py``) and the rest of
``tune.py`` (the tile tables, buckets and bulk window searched) are
ROADMAP.md A.16's next part; A.16's cost attribution, fleet and analysis
tools are ported (``observability.costs``, ``serve.fleet``,
``analysis``)."""
