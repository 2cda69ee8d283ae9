"""The port's counterpart of ``mxnet_tpu/ir``: only ``tune.fit_buckets`` so
far (the serving bucket fit ``ModelServer.retune_buckets`` applies). The
graph IR, its passes and the tile tuning are ROADMAP.md A.16."""
