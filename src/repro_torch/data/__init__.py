from repro_torch.data.batches import synth_train_batch  # noqa: F401
from repro_torch.data.rf_data import shared_rf, synth_rf  # noqa: F401
from repro_torch.data.traces import seed_space  # noqa: F401
from repro_torch.data.tokens import TokenDataset  # noqa: F401
