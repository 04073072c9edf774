"""Hooks on attributes of the program's modules: a call goes through
``fn(original, *args, **kwargs)``.  A hook stands in for the attribute as a
proxy, so that attributes the program keeps on its own functions (the
kernels' launch counters) still read and write the original's."""
import importlib


class Hook:
    def __init__(self, original, fn):
        object.__setattr__(self, "_original", original)
        object.__setattr__(self, "_fn", fn)

    def __call__(self, *args, **kwargs):
        return self._fn(self._original, *args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._original, name)

    def __setattr__(self, name, value):
        setattr(self._original, name, value)


class Hooks:
    """A set of installed hooks, removed again by `remove` (or on leaving a
    ``with`` block), last installed first."""

    def __init__(self):
        self._undo = []

    def add(self, owner, attr, fn):
        """Route ``owner.attr`` (a module, a module's name, or a class)
        through ``fn``."""
        if isinstance(owner, str):
            owner = importlib.import_module(owner)
        original = getattr(owner, attr)
        setattr(owner, attr, Hook(original, fn))
        self._undo.append((owner, attr, original))

    def add_method(self, cls, attr, fn):
        """Route the method ``cls.attr`` through ``fn(original, self, ...)``."""
        original = getattr(cls, attr)

        def method(obj, *args, **kwargs):
            return fn(original, obj, *args, **kwargs)
        method.__name__ = attr
        setattr(cls, attr, method)
        self._undo.append((cls, attr, original))

    def remove(self):
        while self._undo:
            owner, attr, original = self._undo.pop()
            setattr(owner, attr, original)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()
