"""Generic object-registry machinery (counterpart of
``mxnet_tpu/registry.py``; ref: python/mxnet/registry.py).

Upstream exposes three factory-factories keyed by a base class: modules call
``register = get_register_func(Base, 'nickname')`` / ``alias`` /
``create = get_create_func(Base, 'nickname')`` to get per-family registries.
``create`` accepts an instance (pass-through), a registered name, a JSON
config string ``'{"type": "name", ...kwargs}'``, or a ``(name, kwargs)``
pair — the form mx.optimizer/mx.metric/mx.initializer use for
string-configurable components.
"""
from __future__ import annotations

import json

_REGISTRIES = {}  # base class -> {lowercased name: subclass}


def _registry(base_class):
    return _REGISTRIES.setdefault(base_class, {})


def get_register_func(base_class, nickname):
    """(ref: registry.py:get_register_func)"""
    reg = _registry(base_class)

    def register(klass, name=None):
        assert issubclass(klass, base_class), \
            "%s must subclass %s to register as a %s" \
            % (klass, base_class, nickname)
        reg[(name or klass.__name__).lower()] = klass
        return klass

    register.__name__ = "register_%s" % nickname
    return register


def get_alias_func(base_class, nickname):
    """(ref: registry.py:get_alias_func) — decorator adding extra names."""
    register = get_register_func(base_class, nickname)

    def alias(*aliases):
        def reg(klass):
            register(klass)  # its own name too (upstream stacks @register)
            for name in aliases:
                register(klass, name)
            return klass
        return reg

    alias.__name__ = "alias_%s" % nickname
    return alias


def get_create_func(base_class, nickname):
    """(ref: registry.py:get_create_func)"""
    reg = _registry(base_class)

    def create(*args, **kwargs):
        if args and isinstance(args[0], base_class):
            assert len(args) == 1 and not kwargs, \
                "%s instance given: no further arguments allowed" % nickname
            return args[0]
        if args and isinstance(args[0], (tuple, list)) and len(args[0]) == 2 \
                and isinstance(args[0][0], str):
            # ('name', {kwargs}) pair form
            name, conf = args[0]
            conf = dict(conf)
            conf.update(kwargs)
            return create(name, *args[1:], **conf)
        if args and isinstance(args[0], str):
            name, args = args[0], args[1:]
            if name.startswith("{"):  # JSON config form
                conf = json.loads(name)
                name = conf.pop("type")
                conf.update(kwargs)
                kwargs = conf
        else:
            raise ValueError("%s: expected an instance, name, or JSON config"
                             % nickname)
        if name.lower() not in reg:
            raise ValueError("%s %r is not registered (known: %s)"
                             % (nickname, name, sorted(reg)))
        return reg[name.lower()](*args, **kwargs)

    create.__name__ = "create_%s" % nickname
    return create
