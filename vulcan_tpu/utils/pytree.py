"""Pytree dataclass helper.

All framework state (frames, poses, volumes) is a pytree of jnp arrays so that
the whole per-frame pipeline can be a single jitted, donated function.  This is
the JAX replacement for the reference's device-buffer classes
(Vulcan ``Buffer<T>`` / ``Image`` RAII wrappers -- see SURVEY.md L0/L1): XLA
owns memory, we only describe structure.
"""
from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls=None, *, meta_fields: tuple[str, ...] = ()):
    """Decorator: frozen dataclass registered as a JAX pytree.

    ``meta_fields`` are static (hashable, not traced) fields; everything else
    is a child leaf/subtree.
    """

    def wrap(c):
        c = dataclasses.dataclass(frozen=True)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in meta_fields
        )
        jax.tree_util.register_dataclass(
            c, data_fields=data_fields, meta_fields=meta_fields
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)
