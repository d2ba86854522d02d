"""See the counterpart package `vsrcic_tpu.decode`."""
