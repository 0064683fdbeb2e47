from repro_torch.quant.formats import (  # noqa: F401
    PrecisionConfig,
    QuantizedConvTensor,
    QuantizedTensor,
)
from repro_torch.quant.ptq import (  # noqa: F401
    quantize,
    quantize_conv,
    unpack_conv_codes,
)
from repro_torch.quant.qat import fake_quant  # noqa: F401
