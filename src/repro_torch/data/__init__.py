from repro_torch.data.lm import lm_batches, token_stream, token_windows
from repro_torch.data.split import split_clients, train_val_test_split
from repro_torch.data.synthetic import (
    MURA_BODY_PARTS,
    make_cholesterol,
    make_covid_ct,
    make_mura,
)
