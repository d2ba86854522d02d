"""See the counterpart package `vsrcic_tpu.data`; same exports."""
from vsrcic_tpu_torch.data.store import (  # noqa: F401
    DetRecord, HDF5FeatureStore, PackedFeatureStore, SyntheticFeatureStore)
from vsrcic_tpu_torch.data.fields import (  # noqa: F401
    RawField, COCOControlSequenceField, ImageDetectionsField,
    COCOControlSetField, COCOControlSetField_Verb, COCODetSetField,
    COCODetSetField_Verb, SR_2_IDX)
from vsrcic_tpu_torch.data.fields_flickr import (  # noqa: F401
    FlickrDetectionField, FlickrControlSetField, FlickrControlSetField_Verb,
    FlickrDetSetField, FlickrDetSetField_Verb, FlickrControlSequenceField)
from vsrcic_tpu_torch.data.dataset import (  # noqa: F401
    Example, PairedDataset, DictionaryDataset, DataLoader, COCOEntities,
    FlickrEntities)
from vsrcic_tpu_torch.data.synthetic import SyntheticCOCO  # noqa: F401
from vsrcic_tpu_torch.data.gsrl import (  # noqa: F401
    NEWDataset, Dataset_Flickr, collater_new, collater_flickr)
from vsrcic_tpu_torch.data.loader import PrefetchLoader, DevicePrefetchLoader  # noqa: F401
from vsrcic_tpu_torch.data.synthetic_flickr import SyntheticFlickr  # noqa: F401
