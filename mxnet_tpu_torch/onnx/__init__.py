"""ONNX interop (counterpart of ``mxnet_tpu/onnx``; ref:
python/mxnet/onnx). Dependency-free: the protobuf wire format is
implemented in proto.py, so export/import work without the ``onnx`` pip
package. ``export_model`` traces a HybridBlock (or takes a Symbol) to an
ONNX ModelProto; ``import_model`` returns (sym, arg_params, aux_params);
``import_to_gluon`` returns an executable SymbolBlock on a device."""
from .export import export_model, symbol_to_onnx, register_converter
from .import_model import import_model, import_to_gluon, register_importer

__all__ = ["export_model", "symbol_to_onnx", "import_model",
           "import_to_gluon", "register_converter", "register_importer"]
