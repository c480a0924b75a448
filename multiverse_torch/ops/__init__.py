"""Layer library: conv, ConvLSTM, GNN, the fused decode-step kernels, the
int8 tiers' operands, the training attention kernels and the fused
ConvLSTM cell kernel."""

from multiverse_torch.ops.convlstm import (  # noqa: F401
    ConvLSTMState,
    input_dropout,
    convlstm_init,
    convlstm_scan,
    convlstm_step,
)
from multiverse_torch.ops.fused_cell import (  # noqa: F401
    convlstm_step_fused,
    convlstm_step_fused_ref,
)
from multiverse_torch.ops.fused_decode import (  # noqa: F401
    build_emb_gates_tables,
    decode_step,
    decode_step_gathered,
    decode_step_gathered_q8,
    decode_step_gathered_q8_ref,
    decode_step_gathered_q8dyn,
    decode_step_gathered_q8dyn_ref,
    decode_step_gathered_ref,
    decode_step_ref,
    decode_step_v2,
    decode_step_v2_ref,
)
from multiverse_torch.ops.gate_layout import (  # noqa: F401
    GateWeights,
    prepare_gate_weights,
)
from multiverse_torch.ops.gnn import (  # noqa: F401
    gnn_neighbor_mask,
    gnn_step,
    gnn_step_auto,
    gnn_step_neighbors,
)
from multiverse_torch.ops.fused_gnn import (  # noqa: F401
    GnnDense,
    gnn_dense_bwd,
    gnn_dense_bwd_ref,
    gnn_dense_fwd,
    gnn_dense_fwd_ref,
    gnn_step_fused,
)
from multiverse_torch.ops.layers import (  # noqa: F401
    conv2d,
    get_activation,
    init_conv,
    l2_weight_decay,
)
from multiverse_torch.ops.quant import (  # noqa: F401
    DecodeQuant,
    DecodeQuantDyn,
    make_decode_step,
    quantize_decode_weights,
    quantize_decode_weights_v2,
    select_quant,
)
