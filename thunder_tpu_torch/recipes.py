"""Recipes: packaged compile configurations.

thunder_tpu/recipes.py for the port. A Recipe bundles executors, transforms
and jit options; plugins add to them (plugins.py). ``compile(fn, recipe=)``
in the package root resolves one and applies it. The executors are the
port's: cudaex (the hand-written Hopper kernels) first, then torchex (one
torch call a prim)."""
from __future__ import annotations

import warnings
from typing import Callable, Sequence


class Recipe:
    """Base recipe: hooks that collect transforms, executors and options."""

    def __init__(self):
        self.plugins: list = []

    def setup_transforms(self) -> list:
        return []

    def setup_executors(self) -> list:
        from .extend import get_executor

        return [get_executor("cuda"), get_executor("torch")]

    def setup_config(self) -> dict:
        return {}

    def add_plugins(self, plugins: Sequence) -> None:
        self.plugins.extend(plugins)

    def apply(self, fn: Callable, *, plugins=None, **kwargs):
        from . import jit
        from .plugins import resolve_plugin

        if plugins is not None:
            self.add_plugins([resolve_plugin(p) for p in (plugins if isinstance(plugins, (list, tuple))
                                                          else [plugins])])
        transforms = self.setup_transforms()
        executors = self.setup_executors()
        config = self.setup_config()
        for p in self.plugins:
            transforms = p.setup_transforms(transforms)
            executors = p.setup_executors(executors)
            config = p.setup_config(config)
        config.update(kwargs)
        return jit(fn, executors=executors, transforms=transforms, **config)

    @classmethod
    def get_for_model(cls, fn) -> "Recipe":
        if _is_hf_model(fn):
            return HFTransformers()
        return BaseRecipe()


class BaseRecipe(Recipe):
    pass


def _is_hf_model(fn) -> bool:
    for klass in type(fn).__mro__[:-1]:
        if klass.__module__.startswith("transformers.") and klass.__name__ == "PreTrainedModel":
            return True
    return False


class HFTransformers(Recipe):
    """HuggingFace-transformers recipe (thunder_tpu/recipes.py:HFTransformers).

    Validates that the model is a supported ``PreTrainedModel``, switches an
    attention implementation the torch frontend cannot trace (flash-attention
    2's torch kernels) to ``sdpa``, and compiles through the
    ``__torch_function__`` frontend, so the cuda executor claims SDPA and
    cross-entropy whole."""

    SUPPORTED_ARCH_SUFFIXES = ("ForCausalLM", "Model", "ForSequenceClassification",
                               "ForQuestionAnswering", "LMHeadModel")

    def validate(self, model) -> None:
        if not _is_hf_model(model):
            raise ValueError(
                f"HFTransformers recipe expects a transformers PreTrainedModel, got {type(model)}")
        name = type(model).__name__
        if not any(name.endswith(s) for s in self.SUPPORTED_ARCH_SUFFIXES):
            warnings.warn(f"HFTransformers recipe has not been validated on {name}")

    def apply(self, fn, *, plugins=None, **kwargs):
        self.validate(fn)
        cfg = getattr(fn, "config", None)
        if cfg is not None and getattr(cfg, "_attn_implementation", None) not in (None, "eager", "sdpa"):
            warnings.warn(
                f"HFTransformers recipe: switching model config attn_implementation "
                f"{cfg._attn_implementation!r} -> 'sdpa' so the torch frontend can trace it "
                f"(this also affects uncompiled use of the model)")
            cfg._attn_implementation = "sdpa"
        return super().apply(fn, plugins=plugins, **kwargs)


_recipe_registry: dict = {
    "base": BaseRecipe,
    "default": BaseRecipe,
    "hf-transformers": HFTransformers,
}


def register_recipe(name: str, recipe_cls) -> None:
    _recipe_registry[name] = recipe_cls


def resolve_recipe(recipe, fn) -> Recipe:
    if recipe is None or recipe == "auto":
        return Recipe.get_for_model(fn)
    if isinstance(recipe, Recipe):
        return recipe
    if isinstance(recipe, str):
        cls = _recipe_registry.get(recipe)
        if cls is None:
            raise ValueError(f"unknown recipe '{recipe}' (known: {sorted(_recipe_registry)})")
        return cls()
    raise TypeError(f"cannot resolve recipe {recipe!r}")
