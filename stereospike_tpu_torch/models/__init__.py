"""Model zoo: the StereoSpike SNN family (step-major and layer-major
forwards, firing-rate taps) and the equivalent ANN."""

from stereospike_tpu_torch.models.stereospike import (  # noqa: F401
    TAP_NAMES,
    StereoSpikeConfig,
    count_params,
    firing_rates,
    firing_rates_sequence,
    forward,
    forward_sequence,
    init_params,
    init_state,
)
from stereospike_tpu_torch.models.multistep import forward_multistep  # noqa: F401
from stereospike_tpu_torch.models.factory import (  # noqa: F401
    stereospike,
    stereospike_cutpredict,
    stereospike_monocular,
    stereospike_noskip,
    stereospike_tempo,
)
from stereospike_tpu_torch.models.ann import (  # noqa: F401
    AnnConfig,
    ann_forward,
    init_ann_params,
    init_ann_state,
)
