"""Host-side data layer of the port (the port's copy of ``tpualign.data``):
document processing, chunking, captions, the lexical vocabulary and the
operator's filtering, stages 1-2 of the pipeline.

Document parsing is host work in tpualign too; nothing here touches the
device. PDF libraries are optional: the ``MuPDFBackend`` activates when
PyMuPDF/pdfplumber are installed; the ``SyntheticBackend`` reads
deterministic ``*.synthdoc.json`` manuals. Each function is held against
tpualign's by ``tests/test_torch_data.py``.
"""

from tpualign_torch.data.processor import DocumentProcessor  # noqa: F401
from tpualign_torch.data.backends import (  # noqa: F401
    DocumentHandle,
    RasterImage,
    Word,
    SyntheticBackend,
    open_document,
    write_synthetic_document,
)
from tpualign_torch.data.filtering import filter_lexical_components  # noqa: F401
from tpualign_torch.data.lexical import (  # noqa: F401
    extract_lexical_components,
    preprocess_text,
)
