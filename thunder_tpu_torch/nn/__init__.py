from .module import Module, ModuleList, Parameter, ThunderModule, functional_params
from .layers import Embedding, LayerNorm, Linear, RMSNorm
