"""See the counterpart package `vsrcic_tpu.models`."""
