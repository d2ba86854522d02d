"""See the counterpart package `vsrcic_tpu.text`."""
from vsrcic_tpu_torch.text.vocab import (  # noqa: F401
    PUNCTUATIONS, TextField, Vocab, dedup_join)
from vsrcic_tpu_torch.text.tokenizer import ptb_tokenize  # noqa: F401
