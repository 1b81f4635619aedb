from .module import Module, ModuleList, Parameter, ThunderModule, functional_params, update_buffer
from .layers import Embedding, LayerNorm, Linear, RMSNorm
