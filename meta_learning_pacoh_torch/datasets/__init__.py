from meta_learning_pacoh_torch.datasets.data_sim import (
    MetaDataset,
    SinusoidDataset,
    SinusoidNonstationaryDataset,
    GPFunctionsDataset,
    CauchyDataset,
    MNISTRegressionDataset,
    PhysionetDataset,
    SwissfelDataset,
    provide_data,
)
