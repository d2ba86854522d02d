"""See the counterpart package `vsrcic_tpu.ops`."""
