"""{{app_name}}: a unionml_tpu_torch app served as serverless event handlers.

The PyTorch port's ``serverless`` template. Both handlers come from
:mod:`unionml_tpu_torch.serving.serverless` and need no Mangum/boto3:
``handler`` answers API-Gateway events, ``on_upload`` reacts to
object-store upload events (swap ``LocalObjectStore`` for a cloud-backed
store in production). The model is scikit-learn's ``LogisticRegression``
on the digits; it runs on the host, as the reference template's does.

Try locally:
    python app.py                # train + save model.joblib
    UNIONML_MODEL_PATH=model.joblib python -c \
        "from app import handler; print(handler({'httpMethod': 'GET', 'path': '/health'}))"
"""

import pandas as pd
from sklearn.linear_model import LogisticRegression

from unionml_tpu_torch import Dataset, Model
from unionml_tpu_torch.serving.serverless import (
    LocalObjectStore,
    gateway_handler,
    object_event_handler,
)

dataset = Dataset(name="{{app_name}}_dataset", test_size=0.2, shuffle=True, targets=["target"])
model = Model(name="{{app_name}}", init=LogisticRegression, dataset=dataset)


@dataset.reader
def reader(sample_frac: float = 1.0, random_state: int = 42) -> pd.DataFrame:
    from sklearn.datasets import load_digits

    frame = load_digits(as_frame=True).frame
    if sample_frac >= 1.0:
        return frame  # sample(frac=1.0) would shuffle the canonical order
    return frame.sample(frac=sample_frac, random_state=random_state)


@model.trainer
def trainer(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> LogisticRegression:
    return estimator.fit(features, target.squeeze())


@model.predictor
def predictor(estimator: LogisticRegression, features: pd.DataFrame) -> list:
    return [float(x) for x in estimator.predict(features)]


@model.evaluator
def evaluator(
    estimator: LogisticRegression, features: pd.DataFrame, target: pd.DataFrame
) -> float:
    return float(estimator.score(features, target.squeeze()))


# gateway events (GET /, GET /health, POST /predict)
handler = gateway_handler(model)

# object-store upload events: predict each uploaded JSON feature file and
# write <key>.predictions.json back to the same bucket
store = LocalObjectStore("./objectstore")
on_upload = object_event_handler(model, store)


if __name__ == "__main__":
    estimator, metrics = model.train(hyperparameters={"max_iter": 5000})
    print(f"metrics: {metrics}")
    model.save("model.joblib")
