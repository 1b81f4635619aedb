from .module import Module, ModuleList, Parameter, Sequential, ThunderModule, functional_params, update_buffer
from .layers import GELU, Conv2d, Dropout, Embedding, LayerNorm, Linear, ReLU, RMSNorm, Sigmoid, SiLU, Tanh
