"""Layer library: conv, ConvLSTM, GNN and the fused decode-step kernel."""

from multiverse_torch.ops.convlstm import (  # noqa: F401
    ConvLSTMState,
    convlstm_init,
    convlstm_scan,
    convlstm_step,
)
from multiverse_torch.ops.fused_decode import (  # noqa: F401
    decode_step_gathered,
    decode_step_gathered_ref,
)
from multiverse_torch.ops.gnn import (  # noqa: F401
    gnn_neighbor_mask,
    gnn_step,
    gnn_step_neighbors,
)
from multiverse_torch.ops.layers import (  # noqa: F401
    conv2d,
    get_activation,
    init_conv,
)
