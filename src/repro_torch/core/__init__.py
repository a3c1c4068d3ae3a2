"""repro_torch.core — ExPAN(N)D numerics in torch: posit, normalized posit,
PoFx (Algorithm 1), FxP, quantizers, the QuantPolicy grammar, and the
behavioral-analysis / Pareto machinery of Fig. 8 and Tables 3-6.

Re-exports the public names of the reference's ``repro.core``.
"""
from .posit import (  # noqa: F401
    NAR,
    posit_decode,
    posit_decode_np,
    posit_encode,
    posit_encode_np,
    posit_max,
    posit_min_pos,
    posit_value_table,
)
from .normalized_posit import (  # noqa: F401
    norm_compress,
    norm_decode,
    norm_decode_np,
    norm_encode,
    norm_encode_np,
    norm_expand,
    norm_max,
    pack_bits,
    unpack_bits,
)
from .pofx import (  # noqa: F401
    pofx_convert,
    pofx_convert_np,
    pofx_lut,
    pofx_norm_lut,
    pofx_normalized,
    pofx_normalized_np,
)
from .fxp import (  # noqa: F401
    compute_scale,
    fxp_dequantize,
    fxp_dequantize_np,
    fxp_quantize,
    fxp_quantize_np,
)
from .quantizers import (  # noqa: F401
    QuantSpec,
    QuantizedTensor,
    dequantize,
    fxp_view,
    quantize,
    storage_bits,
)
from .pareto import hypervolume, hypervolume_gain, pareto_front, pareto_mask  # noqa: F401
from .policy import (  # noqa: F401
    PRESETS,
    QuantPolicy,
    add_policy_arg,
    format_spec,
    parse_spec,
    policy_from_pareto,
    storage_report,
)
